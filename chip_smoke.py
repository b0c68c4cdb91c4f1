"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. environment: versions, the card's name and power limit, TF32 off;
2. build: every CUDA kernel of the serving paths, one ``nvcc`` per
   source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the full-width main path gives it (fp32 and bf16 K/V) and at a
   GQA shape, with CUDA-event timings and the bound the card could reach;
   the paged kernel also on shuffled pages, on a WARMUP-like row whose K
   table is all null page 0, and bitwise (``torch.equal``) against the
   dense kernel at page = tile; the prefill kernels at a full chunk's
   shapes (bf16 and fp32, GQA, ``flash_prefill`` finalized and as state,
   with an offset, ``paged_prefix_attend`` on shuffled pages at plen
   128/256/384 and at plen 0, which must be the merge identity exactly);
4. a reduced model on the card against the same model on the CPU (the
   plain path): teacher-forced cohort steps, logits held at 1e-4; then
   the continuous engine, paged and dense, cuda against cpu; then the
   chunked continuous engine, cuda against cpu;
5. the cohort main path: full-width chai-llama-7b (bf16, random weights
   from a seed) served through the cohort ``ServingEngine`` — 4
   requests, 32 new tokens each — with every kernel's launches counted
   over that run, and the kernel held against its plain version on the
   layer-0 tensors of the first STEADY step; then the same requests with
   CHAI off (the MHA baseline): exactly 32 ``flash_decode`` launches per
   decode step, no eager decode attention;
6. the continuous main path: the same model through the default
   continuous ``ServingEngine``, 4 slots, 8 requests, once per KV layout
   (paged, then dense), with the launches counted over each run, the
   greedy tokens of the two layouts identical, the KV bytes falling at
   every CLUSTER transition and both pools empty at the end; then the MHA
   baseline (``use_chai=False``) on the same traffic and layouts: every
   decode step launches ``paged_decode`` (paged) or ``flash_decode``
   (dense) once per layer and nothing else, the eager decode attention
   never runs, paged == dense tokens, wall, tok/s and step ms logged
   beside the CHAI runs', and both kernels held against their plain
   versions (and bitwise against each other) on the layer-0 inputs of the
   first decode step with every slot occupied, timed there beside
   PyTorch's ``scaled_dot_product_attention``;
7. the chunked continuous path: the paged run of phase 6 again with
   ``prefill_chunk_tokens=128`` (20 chunks, so 640 launches of each
   prefill kernel), its greedy tokens held against phase 6's on every
   step whose phase-6 top-2 logit margin exceeds ``CHUNK_MARGIN``, the
   prefill kernels held against their plain versions on the layer-0
   inputs of its chunks and timed there;
8. the prefix-cache and relay path: the continuous paged engine with
   ``prefix_cache=True`` serves a 256-token system prompt (warmed by one
   request), eight requests of it plus a private suffix of 32-144
   tokens, then the first of them again (a snapshot hit) and once more
   with a budget its warmup tokens cover (a replay), once with
   ``relay_decode=False`` and once with ``True``: the plan kinds, exactly
   32 launches of each prefill kernel per suffix prefill and of
   ``relay_prefix_decode`` per relay step, identical memberships, the
   warm, snapshot and replay requests' tokens identical and the others'
   held on margins, empty pools after a clear, and the relay kernel held
   against its plain version on the layer-0 inputs of the first relay
   step;
9. the GQA path: chai-llama-7b's weights freed, full-width
   nemotron-4-15b (bf16, random weights from a seed; 8 KV groups of 6
   heads, r_max = 5 reps per group) through the default continuous
   ``ServingEngine`` with phase 6's traffic, on the paged layout and
   then the dense one: launches of the own fused kernel only, each with
   ``reps_per_group = r_max``, identical greedy tokens on both layouts,
   the KV bytes unchanged at every CLUSTER transition (GQA keeps its
   dense pages until retirement), empty pools, and both fused kernels
   held against their plain versions on the layer-0 GQA tensors of the
   first all-STEADY step; then, on its first ``SIDE_DEPTH`` layers,
   nemotron's MHA baseline as in phase 6 and phase 8's prefix traffic
   with relay off then on (every request a
   ``"prefix"`` hit: a GQA model takes no CHAI snapshot; relay launches,
   relay tokens held against plain ones on margins, no page left after a
   clear);
10. the fused-vs-pipeline lane (the reference's
   ``benchmarks/bench_latency.py`` lane): the three-kernel pipeline
   (``kernels.ops.chai_three_kernel_decode`` /
   ``paged_chai_three_kernel_decode``) and the fused kernel on the same
   inputs, the counts set to 0 just before each call and read just
   after: exactly 3 launches against 1, the outputs equal at 1e-4, on
   the reference lane's shape (b=4, h=8, r=5, s=256, hd=32, ts=64; also
   with int8 K through ``chai_qk_i8``, the fused side then its plain
   version) and on the layer-0 inputs of the first STEADY step of phases
   5, 6 and 9, and, on a run of its own, of phase 12's share_values
   int8 dense run (int8 K with scales, the clustered V's raw codes: the
   pipeline's ``chai_av`` on int8 codes against the fused kernel's share
   + int8 mode); each kernel's device time, back-to-back and single-call
   times, and ``decode_hbm_bytes_estimate`` of both; then the six
   pipeline kernels against their plain versions at the main path's and
   nemotron's shapes, and the AV pair on the share int8 input;
11. the int8 KV cache (``cfg.replace(kv_cache_dtype="int8")``) at full
   width: chai-llama-7b after phase 8 on phase 6's traffic,
   paged then dense (launches of the layout's own fused kernel only, in
   its int8 mode; paged == dense tokens; ``kv_bytes()`` at the first
   all-STEADY step exactly 132/256 of the bf16 run's; tok/s, TTFT, step
   ms and device memory peak beside the bf16 run's; greedy agreement
   with it, information only), then, on the first ``SIDE_DEPTH`` layers,
   the MHA baseline on the int8 cache (``flash_decode`` over the
   dequantized view on both layouts) and phase 8's prefix traffic, relay
   off then on (the int8 modes of ``paged_prefix_attend`` and
   ``relay_prefix_decode``); nemotron-4-15b
   after phase 9, phase 6's traffic, paged then dense; the fused pair
   held against its plain version on each run's first all-STEADY layer-0
   int8 tensors;
12. ``share_values`` (CHAI-QKV, ``cfg.with_chai(share_values=True)``) on
   full-width chai-llama-7b after phase 11: the cohort on phase 5's
   traffic, then phase 6's traffic paged then dense, bf16 and int8
   (launches of the layout's own fused kernel only, every call in the
   share mode; paged == dense tokens; ``kv_bytes()`` falling at every
   CLUSTER by exactly the slot's dense K and V pages, and at the first
   all-STEADY step exactly 50/57 of the K-only run's, phase 6's for bf16
   and phase 11's for int8; empty pools), then phase 8's prefix traffic
   on the first ``SIDE_DEPTH`` layers, relay off then on, bf16 and int8
   (the share shape of the relay maps,
   scale-less int8 V); the fused pair held on each run's first
   all-STEADY layer-0 tensors and the relay kernel on the first relay
   step's;
13. local-attention rings and the softcap, after chai-llama-7b and
   nemotron-4-15b are freed: gemma2-9b at full width on its first
   ``SIDE_DEPTH`` of 42 layers (alternating local and global, 16 heads
   over 8 KV heads, head_dim 224, window 4096, softcaps 50 / 30; bf16,
   random weights from a seed, made at that depth) through the
   cohort on phase 5's traffic and the continuous engine on phase 6's,
   paged then dense, each followed by its MHA baseline: the layout's
   fused kernel launched in its softcap mode once a global layer a step
   with a STEADY slot and nothing else, the local layers
   decoding eagerly over their rings; the baselines launch nothing (the
   flash decode kernels have no softcap; every layer eager); paged ==
   dense tokens; ``kv_bytes()`` on the reference's formula with the
   rings; empty pools; the fused pair held at 2e-5 on the first
   all-STEADY step's layer-0 global tensors. Then h2o-danube-1.8b at
   full width on its first ``SIDE_DEPTH`` of 24 local layers (32 heads
   over 8, head_dim 80; its weights made at that depth) in a
   max_seq of 8192 with a 5000-token prompt (its ring wraps; the
   cohort's bucket is 8192): the cohort, then the continuous engine on
   the unified layout (no global layer, nothing paged), greedy tokens of
   the two schedulers held equal on margin-checked steps;
14. the int8 KV cache with local layers: gemma2-9b on
   ``kv_cache_dtype="int8"`` on phase 13's weights (int8 global caches
   and pools with their scales, bf16 rings): phase 13's traffic on the
   cohort and the continuous engine, paged then dense, each with its MHA
   baseline; the fused pair launched as often as in the bf16 run, every
   call on int8 codes in the softcap mode; paged == dense tokens;
   ``kv_bytes()`` on the reference's formula; step times and memory
   beside the bf16 run's. gemma2's model-level suffix prefill
   (``forward_fullseq(prefix_len, prefix_kv)``), bf16 and int8 pages: a
   launch of each prefill kernel a global layer in the softcap mode,
   greedy tokens
   held against the plain route on margins. h2o-danube-1.8b on int8
   (nothing quantized): its tokens equal its bf16 tokens;
15. the front door (``serving.api``) on chai-llama-7b after phase 12, on
   phase 6's engine settings with the prefix cache: ``LLM.generate`` of
   phase 6's first four prompts, two greedy and two seeded (temperature
   0.8, top-k 50, top-p 0.95), the fused kernel its only launch; the same
   tokens from ``EngineCore.add_request`` / ``step``, from a second
   ``LLM``, on the dense layout and on the cohort; stop strings with the
   space-joined-ids detokenizer ending at ``scan_finish``'s first match;
   a stream's first chunk (host time) then its abort, both pools empty
   after a clear; a 3-turn ``Session`` whose later turns alias cached
   pages; tok/s and the median step time, all greedy against all seeded
   in turns; the sampler on one step's logits, the card's picks equal to
   the CPU's on a copy, its device time against ``argmax``'s, and its
   host time piece by piece. On nemotron-4-15b after phase 11, the seeded
   ``generate`` repeated by a second ``LLM`` and on the dense layout;
16. the paper's offline phase and policies on chai-llama-7b after phase
   15: ``launch.offline_clustering.offline_phase`` on 16 calibration
   sequences of 24 tokens (32 elbow-selected counts and mean |off-diagonal|
   correlations; the CPU's counts on a copy of the features equal, or
   parted only where a gain lies within 1e-6 of ``plateau_tol``), and
   ``core.policy.apply_policy`` for the seven policies on layer-0 q, k, v
   of a 512-token prefill in fp32, the card's outputs at 2e-5 of the
   CPU's, ``score_flops`` and memberships exact (a two-head tie held
   through the CPU's membership);
17. the failure model (``serving.faults``, ``serving.invariants``,
   ``serving.soak``) on chai-llama-7b after phase 16, on phase 6's engine
   settings: (a) the soak, ``build_workload(0, 12)`` at page 16 with its
   priority-1 arrivals and one more duplicate of its family prompt at
   step 41, on 2 slots (the clean run preempts twice), prefix cache and
   relay on, ``audit_level="deep"``, clean and
   twice under a plan arming ``pool.alloc`` (transient and error),
   ``snapshot.restore``, ``relay.residency``, ``kernel.prefill``,
   ``kernel.cluster`` and ``step.logits``: every request typed-terminal,
   a clean deep audit after every step, no leak, every arm fired and
   fired alike in both faulted runs, the untouched completed requests'
   tokens the clean run's (a divergence only on a clean top-2 margin <=
   ``CHUNK_MARGIN``), the clean run through CLUSTER transitions, relay
   steps, a snapshot restore and all four serving kernels; (b) phase 6's
   paged traffic with ``kernel.decode`` armed at decode step 8 and
   ``decode_heal_steps=8``: one fallback, one heal, 0
   ``paged_chai_fused_decode`` launches on each of the 9 degraded steps
   (the plain versions run) and one a layer on every CHAI step on the
   kernels, greedy tokens held against phase 6's on margins, the
   degraded step's ms beside the kernels'; (c) phase 6's paged traffic
   at ``audit_level`` off, basic and deep in turns, once each: median
   ``step()`` ms, the host ms of one ``audit`` call, and the
   device-to-host copies of one all-STEADY decode step of a bare engine
   (``torch.profiler``; one expected at off and basic); (d)
   ``LLM(faults=...)``: a stream quarantined by NaN logits ends on an
   ``"error"`` chunk, the other stream's tokens a clean ``LLM``'s;
18. telemetry on chai-llama-7b after phase 17: one all-STEADY decode
   step of a bare engine profiled at telemetry "trace" against phase
   17c's at "off" (the same device kernels and counts, one device-to-host
   copy each); phase 6's paged traffic on the first ``SIDE_DEPTH``
   layers at "off", "basic" and "trace" in turns, clustering through the
   off turn's memberships, launches equal to its; the run at "trace"
   checked span by span (each decoding step one
   ``cluster``, ``relay.form``, ``decode.dispatch``, ``sample``,
   ``retire``, ``step`` and ``audit`` span and at least one ``admit``,
   contiguous step ordinals, the Chrome trace read back by
   ``from_chrome_trace``), its metrics against ground truth (tokens
   served, 8 requests finished, 8 TTFT observations, the CLUSTER
   transitions), its Prometheus text parsed back, its tokens held against
   the off turn's on margins; the median ``step()`` ms of every run beside
   the interquartile range of its steps, and one ``tel.span`` enter/exit
   pair's host µs;
19. the KV tiers on chai-llama-7b's first ``SIDE_DEPTH`` layers: three
   families of prompts sharing a 256-token prefix (``tier_waves``), a wave a family and then the first
   family again with a repeat of its first prompt (a snapshot hit), on
   the continuous paged engine with the prefix cache and a deep audit
   after every step: a roomy run (nothing evicted), then
   ``kv_offload=True`` with a dense pool of 110 pages (the third wave
   demotes, the fourth promotes; every promoted page ``torch.equal`` to
   the page before its demotion, plans and tokens equal to the roomy
   run's, ``flash_prefill`` and ``paged_prefix_attend`` launched once a
   layer per suffix prefill), then the same under a corrupt
   ``offload.out`` arm (checksum failures
   caught at promotion, nothing promoted or quarantined), and with a
   host pool of 12 pages (the int4 rung used, a compressed hit dropped
   and re-planned); every pool empty after a
   clear; demotion and promotion ms of a page of each pool (CUDA events
   around the copies, the CRC on the host clock) beside a 256 MB pinned
   host <-> device copy, the host link;
20. priority preemption, the async front door and the HTTP server on
   chai-llama-7b after phase 19: (a) on its first ``SIDE_DEPTH`` layers,
   the continuous paged engine with 2
   slots and pools just above one request's need (a 160-token prompt and
   16 new tokens: 11 pages each of K and V), a priority-0 request
   decoding 8 steps into STEADY and a priority-5 arrival preempting it;
   again with the victim in WARMUP (2 steps), in PREFILL (the first 64-token
   chunk of a chunked prefill; it saves nothing and prefills again) and
   on the MHA baseline (``use_chai=False``): the victim's and the
   preemptor's tokens equal to each alone, bit for bit, one preemption,
   ``paged_chai_fused_decode`` (``paged_decode`` on the baseline)
   launched once a layer on every decode step of the victim's return,
   the pools and the host tier back at their base, no checksum failure;
   the STEADY slot's swap piece by piece a page (the gather, the copy to
   pinned host pages, the host CRC, the upload, the scatter; CUDA events,
   the CRC on the host clock) and the engine's own swap-out and swap-in
   walls; (b) the same with ``swap.corrupt`` and then ``swap.in`` armed:
   the victim alone quarantined, the preemptor's tokens untouched; (c)
   ``AsyncLLM``: 16 concurrent streams on phase 6's engine settings, 4
   aborted after their first chunk, the survivors equal to the
   synchronous ``LLM``'s tokens, every page back; then
   ``launch.serve_http.selftest`` on loopback ports the OS picks, its
   engine built on the same weights (200 / SSE / 400 / 408 / 429 / 500 /
   503, the metrics and timeline routes);
21. the attention archs of ROADMAP #14 part B, after every earlier
   model is freed: (a) full-width gemma3-4b at full depth (34 layers, 5
   global: 5, 11, 17, 23, 29; window 1024; 8 heads over 4 KV groups,
   head_dim 320, qk_norm; bf16, random weights from a seed) through
   phase 13's path (``gemma2_path``) with its MHA baselines at full
   depth: the cohort, then the continuous engine paged and dense, CHAI
   then the MHA baseline; the fused pair launched 5 times a step with a
   STEADY slot, the flash decode pair 5 times an MHA-baseline step, all
   in their wide-head mode, the local layers eager; paged == dense
   tokens; KV bytes unchanged at CLUSTER (GQA); the four kernels held at
   2e-5 on the first all-STEADY (first full) step's first global layer.
   (b) full-width deepseek-moe-16b at full depth (28 layers, MHA 16
   heads, hd 128; the dense FFN then 27 MoE layers of 64 experts top-6
   and 2 shared; 32.8 GB in bf16) on the continuous paged engine, CHAI
   then the MHA baseline (``moe_serving_path``): launches 28 a step, KV
   bytes falling at every CLUSTER, pools empty; then
   ``moe_step_profile``: an all-STEADY and a mixed decode step between
   CUDA events with every FFN call timed (the MoE FFN's share of the
   step, the capacity form against its expert weights' bytes), and the
   device-to-host copies of the next step of each kind. (c)
   qwen3-moe-30b-a3b, internvl2-76b and musicgen-large on their first
   ``SIDE_DEPTH`` layers at full widths, their weights made at the cut
   config directly (``init_full_model(arch, n_layers)``: internvl2 is
   141 GB in bf16, and qwen3's expert stacks would be staged in fp32),
   through ``moe_serving_path``: launches n_layers a step, every pick's
   logits finite, pools empty;
22. the recurrent archs of ROADMAP #14 part B, after every earlier model
   is freed (``recurrent_paths``), none of whose paths runs a TPU kernel:
   full-width recurrentgemma-9b at full depth (38 layers: 26 RG-LRU and
   12 local MQA layers, window 2048, no global layer; 10.45 B
   parameters, 20.9 GB in bf16) and rwkv6-1.6b at full depth (24 RWKV
   layers, 3.17 GB), bf16, random weights from a seed, each through
   ``recurrent_path``: the cohort on phase 5's traffic (recurrentgemma
   CHAI then the MHA baseline, rwkv the baseline), then the continuous
   engine on ``ZOO_TRAFFIC`` asked for the paged layout and running the
   unified one (no global layer): recurrentgemma CHAI twice and the MHA
   baseline, rwkv the baseline twice (its engine refuses
   ``use_chai=True``); the repeat equal bit for bit (tokens and every
   top-2 margin); every logit finite; each of the 13 kernels' counters 0
   over every run; the eager decode attention once an attention layer a
   baseline step; ``kv_bytes()`` the rings only; one device-to-host copy
   a decode step (``torch.profiler``); the first recurrent layer's
   prefill at the longest prompt's bucket (512) and its decode step of 4
   rows by CUDA events; and the recurrent state on the card
   (``recurrent_state_check``: a 64-token prompt, its own bucket, and 16
   greedy decode steps against one ``forward_fullseq`` over the prompt
   and the generated tokens, in fp32 on the same weights logits within
   ``STATE_F32_TOL`` and greedy tokens equal on margin-checked steps, in
   bf16 the max and mean logit differences bounded); wall, tok/s, TTFT,
   decode step ms by kind and the device memory peak above each run's
   start logged;
23. the training stack of ROADMAP #15 (``training_paths``; run after
   phase 4, on a card that holds nothing else), none of whose training
   runs launches a TPU kernel: (a) full-width chai-llama-7b at SIDE_DEPTH layers (bf16,
   remat, 8 x 128 tokens of the port's pipeline): the fused train step
   against two microbatches on one batch, then 20 steps with the loss
   falling by more than 0.3, the step split into forward + backward and
   the optimizer by CUDA events, tokens/s, the FLOP share of the bf16
   peak and the device memory peak; (b) at 2 layers through ``Trainer``:
   10 steps straight against 5, a save, a fresh trainer's restore and 5
   more (final loss at rtol 1e-5, every leaf's max abs difference, GB
   written, seconds to save and restore); (c) that checkpoint restored
   and served on ``ZOO_TRAFFIC`` by the continuous paged engine, the
   tokens equal to the in-memory params' and the fused pair launching,
   then the tiny model of ``tests/test_system.py`` trained on the card
   for 60 steps, its offline elbow, and served on 32 prompts: CHAI's greedy agreement with
   MHA above 0.7, and CHAI at least round-robin membership less 0.05;
24. a ``kernels`` JSON line (the thirteen kernels, a ``[int8]`` row for
   each of the four int8 modes, its launches those of its phase-11 path,
   a ``[share]`` row for each of the three share modes, its launches
   those of its phase-12 path, a ``[softcap]`` row for each of the two
   softcap modes of the fused pair, its launches those of its gemma2
   path in phase 13, an ``[int8+softcap]`` row for each of them on
   phase 14's paths, and the rows of the prefill pair's and the relay's
   modes: ``flash_prefill[softcap]``, ``paged_prefix_attend[softcap]``
   and ``[int8+softcap]`` on gemma2's suffix prefill, the AV pair's raw
   int8 V (``chai_av[int8]`` on phase 10's share int8 lane), and
   ``flash_prefill[window]``, ``relay_prefix_decode[softcap]``,
   ``paged_chai_av[int8]`` and the QK pair's raw int8 K
   (``chai_qk[int8]``, ``paged_chai_qk[int8]``), which no path of the
   reference reaches: their launches are counted by mode
   (``kernels.chai_attention.MODE_LAUNCHES``) over every run of the
   process and must be 0), a ``[wide]`` row for each of the four decode
   kernels at head dim 320, its launches those of its gemma3-4b path in
   phase 21a, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

Phase 3 also holds the wide head (``wide_head_checks``): the fused pair
on its wide-head libraries (``build.VARIANTS``: the sources built again
with the head dim fixed at 320) and the flash decode pair on its kWideHd
instance, at gemma3-4b's layout (8 heads over 4 KV groups, 2 reps a
group, bf16, page 16): several splits with a partial last one, a
WARMUP-like row, a row of S = 65,536, and gemma3's full-width decode;
each at 2e-5 against its plain version, paged == dense and two launches
bitwise, a poisoned null page and poisoned positions past pos changing
no bit, SDPA timed beside ``flash_decode`` with the backend it picks at
head dim 320 named from its kernels; every such launch counted in the
``wide`` mode; then the hd-128 rows of the four kernels on
chai-llama-7b's shapes, timed in the same run. Phase 4 also runs the
five archs of phase 21 and the two of phase 22 reduced, cuda against cpu
(``reduced_arch_checks``: the teacher-forced reference check, rwkv's as
plain decode steps with every state leaf held; the continuous engine
paged and dense, rwkv without CHAI, the recurrent archs on the unified
layout with no launch; and forward and decode on float embeddings for
the two frontend archs).

Side paths (``SIDE_DEPTH``): phase 11's nemotron-4-15b int8 pair runs on
the first SIDE_DEPTH layers against a K-only pair of that depth, and
phase 14's gemma2-9b int8 CHAI runs on the first SIDE_DEPTH layers, their
launches held against phase 13's per global layer; each logs its
seconds.

Phase 3 also holds the modes of the prefill pair and the relay kernel
(``prefill_mode_checks``), every case on queries of std 4 under gemma2's
cap of 50, each at 2e-5 against its plain version: ``flash_prefill``
capped, windowed and both at hd 128 and 224, bf16 and fp32, finalized
and as the state, T = 128 at offset 384 over S = 512 (the window of 128
skips four 64-key tiles), and rows that see no key inside a window of 32
as the exact merge identity; ``paged_prefix_attend`` capped over bf16,
fp32 and int8 pools at hd 128 and 224; ``relay_prefix_decode`` capped on
MHA, GQA and share_values maps, bf16 and int8 (the share maps' raw int8
V codes held over l and over their range of 127); two launches, softcap
0 and an unreachable window ``torch.equal`` to the plain launch; the
capped output unequal to the uncapped one; and gemma2's suffix prefill
in one global layer at full width (``gemma2_suffix_prefill_check``:
``paged_prefix_attend`` over 256 paged positions merged with
``flash_prefill`` over a 128-token suffix, against the eager attention
over all 384, bf16 and int8 pages).

Phase 3 also holds the softcap mode of ``chai_fused_decode`` and
``paged_chai_fused_decode`` (``softcap_kernel_checks``) in every other
mode, at hd 128 (chai-llama-7b's MHA and nemotron's GQA shapes) and hd
224 (gemma2's: its GQA shape, 16 heads over 8 groups of 2 reps, and an
MHA one): bf16 at cap 50 with several splits, a WARMUP-like row, fp32 at
cap 5, int8 K/V with scales, share_values bf16 and int8, GQA bf16 and
int8, and one gemma2 row of S = 65,536; each at 2e-5 against its plain
version (the state too), paged == dense, two launches and emit + empty
merge + finalize ``torch.equal``, the capped output unequal to the
uncapped one, with its times and bound (the uncapped mode beside on the
two bf16 split cases).

Phase 3 also holds the int8 modes of ``chai_fused_decode``,
``paged_chai_fused_decode``, ``relay_prefix_decode`` and
``paged_prefix_attend`` (``int8_kernel_checks``: codes and scales from
``quant_rows``, hd 128, page 16; MHA and nemotron's GQA; shuffled pages
with the null page 0; a padded relay slot; plen 0 as the merge identity;
the fused pair and the relay kernel at S = Sp = 65,536; paged == dense and
two launches ``torch.equal``), each at 2e-5 against its plain version with
its device, back-to-back and single times and its int8 bound beside the
same kernel's bf16 numbers on the same shapes.

Phase 3 also holds the share_values modes of ``chai_fused_decode``,
``paged_chai_fused_decode`` and ``relay_prefix_decode``
(``share_kernel_checks``: V clustered like K, R rows; bf16 with several
splits, a WARMUP-like row with all-null K and V tables, S = 65,536; int8
K with scales beside raw V codes without; the relay on the share maps,
Sp 256 and 65,536; paged == dense, two launches and emit + empty merge +
finalize ``torch.equal``), each at 2e-5 against its plain version, with
its times and bound beside the K-only mode's on the same shapes.

Phase 3 also holds ``flash_decode`` and ``paged_decode`` against their
plain versions on the reference's sweep shapes (MHA, GQA 4:1, MQA, one
tile, a window of 24; fp32 and bf16) and at full width (chai-llama-7b's
32 heads and nemotron's 48 over 8 KV heads, bf16, with SDPA timed
beside), paged == dense bitwise at ts == page on every case, and a null
page (and dense positions past pos) poisoned with 999 changing no output
bit; phase 4 also runs the MHA baseline (paged, dense, cohort) and the
prefix cache + relay engine on reduced nemotron, cuda against cpu. The
CHAI runs of phases 5-9 launch neither flash decode kernel (their
WARMUP keeps the eager attention, which needs the probabilities).

Phase 3 also holds the six pipeline kernels (``chai_qk``, ``chai_qk_i8``,
``paged_chai_qk``, ``row_softmax``, ``chai_av``, ``paged_chai_av``) at
the full-width shapes: fp32 and bf16, MHA and GQA, a window, a row at
pos 2, shuffled pages with the null page 0 past pos, int8 K from the
port's ``quant_rows``, masked scores ``torch.equal`` to -2e38 and a fully
masked row's softmax all zeros; the QK pair also on K's raw int8 codes
and the AV pair on V's (held over their range of 127), each QK and AV
launch twice bitwise, paged == dense ``torch.equal`` at ts = page, a
yardstick timed beside it (QK: the K rows gathered + ``torch.matmul`` +
``masked_fill``; AV: ``torch.gather`` + ``torch.matmul``), the three QK
kernels at S = 65,536 (B 1, 25 reps, bf16, int8 with scales and raw
int8 codes) and both AV kernels there (bf16 and int8), ``row_softmax``
and ``torch.softmax`` timed in turns on the device, and ``row_softmax``
at S = 65,536 (one thread block cluster a row, read once) and 131,072
(streamed, read twice), held raw and scaled by S (the mean entry is
1 / S), a row masked everywhere giving zeros, beside
``torch.softmax`` in turns; phase 4 also runs reduced nemotron (2 KV
groups of 6 heads, head_dim 8) cuda against cpu.

Phase 3 also holds every K/V pairing the Pallas wrappers take beyond the
serving paths' (``kv_pairing_checks``: K and V each fp32, bf16 or int8,
each with or without its row scales) in the fused pair (MHA, GQA, share
and softcap cases, one of S = 65,536), the relay kernel and the prefix
pass, against their plain versions at 2e-5 (raw int8 V over 127), paged
== dense and launch == launch bitwise; each pairing on the general body
(``ck.kv_body``) has its row ("<kernel>[kv=<K>/<V>]"), with 0 launches
on every serving path (held: any launch by a "kv=" mode in a serving
run fails the script); the fused pair's int8 K with scales beside raw
int8 V runs the int8 body and its cases join the "[int8]" rows. Phase
10's int8 lanes run the fused kernel on int8 K beside float V (rows
``chai_fused_decode[kv=i8s/f32]`` and ``[kv=i8s/bf16]``, path
``pipeline_lane``).

Phase 3 also holds ``relay_prefix_decode`` on synthetic groups (G = 2,
4 and 3 members of 25 reps, plen 200 and 256, bf16 and fp32; GQA maps
with 20 query rows on each K row, and with a group of 3 in ``nmax`` 4;
three groups at plen 200, 1024 and 0 in a view of 1024, whose later
splits lie wholly past plen), each case launched twice with equal bits
and its plan (score and sum units, splits, blocks) and the prefix rows
its blocks stream logged, and both
decode kernels' ``emit_state`` mode (against the plain versions; paged
== dense bitwise; emit + merge with the empty state + finalize equal to
the finalized launch bit for bit); phase 4 also runs the reduced engine
with ``prefix_cache=True, relay_decode=True``, cuda against cpu.

The fused decode pair's block body cuts S into whole-tile splits (the
plan of ``kernels.chai_attention.split_plan``) merged in split order
inside the launch, with fixed shared memory. Phase 3 also holds both
kernels at 2e-5 on split cases at full width (bf16, page 16): several
splits with a partial last one, rows whose splits past the first lie
beyond pos (one at pos 0), a WARMUP-like row (every head in rep 0, an
all-null K table), nemotron's GQA shape, and one row of S = 65,536 (MHA
and GQA), above the shared-memory cap the first design had; on each,
paged == dense ``torch.equal`` at page = tile, two launches bitwise
equal, and emit + empty-state merge + finalize bitwise equal to the
finalized launch; and ``relay_prefix_decode`` at Sp = 65,536 (two
groups, plen 65,536 and 50,000; each acc row held over its l at 2e-5,
since the raw sums over that many positions round apart by ~1e-7 of
l). Phase 10 also logs, for each input,
the fused kernel's device time over the pipeline's three-kernel device
time and over its bound. The ``kernels`` rows of ``row_softmax``,
``flash_decode`` and ``flash_prefill`` carry the library call's device
time (``library_device_ms``, every kernel of the call in a
``torch.profiler`` trace) beside its back-to-back ``library_ms``.

The prefill pair runs its products on the tensor cores and the flash
decode pair cuts S into splits merged inside the launch. Phase 2 logs
the tensor-core instructions in each rewritten kernel's SASS
(``tensor_core_counts``). Phase 3 also holds ``flash_prefill`` at T = 128
over S = 512 at offset 384 (MHA and GQA, bf16 and fp32, finalized and as
state) and at a ragged T = 77 (GQA, offset 200), times causal SDPA with
``enable_gqa`` beside the GQA chunk, and holds ``flash_decode`` /
``paged_decode`` on split cases (a partial last split, a row at pos 0,
nemotron's 48 heads over 8, one row of S = 65,536, MHA and GQA), every
flash decode case launched twice with equal bits. The last log lines
before the ``kernels`` line give the rewritten kernels' rows: device,
back-to-back and single-call times, bound and the library's device time.
"""
from __future__ import annotations

import asyncio
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import cache as chai_cache  # noqa: E402
from repro_torch.core import chai_attention as chai_core  # noqa: E402
from repro_torch.core import clustering  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import chai_attention as ck  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig, SyntheticPipeline, calibration_batches)
from repro_torch.launch import (  # noqa: E402
    offline_clustering, serve_http, steps)
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import exporters  # noqa: E402
from repro_torch.serving import faults as faults_mod  # noqa: E402
from repro_torch.serving import invariants as invariants_mod  # noqa: E402
from repro_torch.serving import kv_tiers as kv_tiers_mod  # noqa: E402
from repro_torch.serving import sampling as sampling_mod  # noqa: E402
from repro_torch.serving import soak as soak_mod  # noqa: E402
from repro_torch.serving.api import LLM, Session  # noqa: E402
from repro_torch.serving.async_api import AsyncLLM  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig, EngineCore, ServingEngine)
from repro_torch.serving.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.serving.sampling import (  # noqa: E402
    FINISH_LENGTH, SamplingParams)
from repro_torch.serving.telemetry import make_telemetry  # noqa: E402
from repro_torch.train import train_step as train_step_mod  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
TOL = dict(atol=2e-5, rtol=2e-5)
# A finalized bf16 output rounds the fp32 result once, and the kernel and
# the plain version may round a value whose fp32 forms differ in the last
# bits to neighbouring bf16 values: one bf16 step (2^-7 relative).
BF16_OUT_TOL = dict(atol=2e-5, rtol=2 ** -7)
ARCH = "chai-llama-7b"
NEMO = "nemotron-4-15b"        # the GQA model (8 KV groups of 6 heads)
PROMPT_LENS = (200, 320, 450, 500)
MAX_NEW = 32
CONT_PROMPT_LENS = (200, 320, 450, 500, 96, 160, 384, 256)
CONT_MAX_NEW = (32, 48) * 4
MAX_SEQ = 1024
PAGE = 16
SLOTS = 4
CHUNK = 128
# Phase 7 holds a chunked run's greedy token to the monolithic run's where
# the monolithic top-2 logit margin exceeds this. The two prefills round
# bf16 activations at different places (the chunk's two-pass attention
# against the whole-prompt one); logits of this model are ~N(0, 1), and
# their rounding differences are expected around 1e-2.
CHUNK_MARGIN = 0.1
# Phase 8: a 256-token system prompt, warmed by one request, then eight
# requests of the prompt plus a private suffix, then the first of them
# again (a snapshot hit) and once more with a budget its warmup tokens
# cover (a replay).
SYS_LEN = 256
SUFFIX_LENS = (32, 64, 96, 128, 48, 80, 112, 144)
SUFFIX_NEW = (32, 48) * 4
# Side paths run the first SIDE_DEPTH layers of the full-width model
# (``cut_depth``): on chai-llama-7b the int8 and share_values continuous
# and prefix runs and the int8 MHA baseline (phases 11 and 12, held
# against K-only runs of the same depth, ``side_konly``), the sampler's
# rate turns (15), the soak and the audit-cost runs (17a, 17c); on
# gemma2-9b, every run of phases 13 and 14; nemotron-4-15b's MHA baseline,
# prefix and relay runs (9) and int8 pair (11), h2o-danube-1.8b (13,
# 14), the telemetry tier turns (18), every KV-tier run (19), the
# preemption runs (20a-b), and the side archs of phase 21c (gemma2's, danube's and their weights made at the
# cut depth). Their checks hold per layer
# (launches n_layers a step; byte ratios, tokens and schedules inside one
# depth), the kernels see the full-width shapes, and the full-depth runs
# are the main paths': the launch counts of phases 5-9 and 13 stand. The
# serving engines are host-bound (about 3000 launches a decode step), and
# hosts differ by 1.6x in speed: the cut keeps the script inside its time
# limit on the slowest.
SIDE_DEPTH = 8
KERNEL_ROWS = {
    "chai_fused_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/chai_fused_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:487"),
    "paged_chai_fused_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_chai_fused_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:579"),
    "flash_prefill": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_attention.py:273"),
    "paged_prefix_attend": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_prefix_attend.cu",
        replaces="src/repro/kernels/flash_attention.py:413"),
    "relay_prefix_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/relay_prefix_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:766"),
    "chai_qk": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_qk.cu",
        replaces="src/repro/kernels/chai_attention.py:76"),
    "chai_qk_i8": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_qk.cu",
        replaces="src/repro/kernels/chai_attention.py:203"),
    "row_softmax": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/row_softmax.cu",
        replaces="src/repro/kernels/chai_attention.py:115"),
    "chai_av": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_av.cu",
        replaces="src/repro/kernels/chai_attention.py:255"),
    "paged_chai_qk": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_qk.cu",
        replaces="src/repro/kernels/chai_attention.py:146"),
    "paged_chai_av": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_av.cu",
        replaces="src/repro/kernels/chai_attention.py:296"),
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:74"),
    "paged_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:158"),
}
# Calls of the eager decode attention (``models.transformer.
# _decode_attention_batched``, kept for CHAI WARMUP, which needs the
# probabilities); ``count_eager_decode`` installs the counter.
EAGER = {"calls": 0}


def count_eager_decode():
    inner = tfm._decode_attention_batched

    def counted(*args):
        EAGER["calls"] += 1
        return inner(*args)
    tfm._decode_attention_batched = counted


_T0 = time.time()


def log(msg):
    """One log line, stamped with the seconds since the script started."""
    print(f"[chip_smoke {time.time() - _T0:7.1f}s] {msg}", flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ------------------------------------------------------------ phase 1 ----
def environment():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    release = [ln for ln in nvcc.splitlines() if "release" in ln]
    log(f"nvcc: {(release or nvcc.strip().splitlines())[-1].strip()}")
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line()}")


# ------------------------------------------------------------ phase 2 ----
def build_kernels():
    t0 = time.time()
    seconds = {}
    outputs = build.build_all(extra_flags=("-Xptxas", "-v"), seconds=seconds)
    log(f"built {sorted(outputs) or 'nothing (up to date)'} in "
        f"{time.time() - t0:.3f} s; each source's seconds, all started "
        f"together: { {n: round(t, 1) for n, t in seconds.items()} }")
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for name in KERNEL_ROWS:
        build.load(name)
    tensor_core_counts()


# The kernels whose SASS is logged for tensor-core instructions: the
# prefill pair (mma.sync) and the flash decode pair (none expected).
REWRITTEN = ("flash_prefill", "paged_prefix_attend", "flash_decode",
             "paged_decode")


def tensor_core_counts():
    """Log the tensor-core instructions in each rewritten kernel's SASS
    (``cuobjdump -sass`` of the built library): HMMA for ``mma.sync``,
    HGMMA for ``wgmma``. For the record, not a gate."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    for name in REWRITTEN:
        sass = subprocess.run(
            [str(tool), "-sass", str(build.BUILD_DIR / f"lib{name}.so")],
            capture_output=True, text=True).stdout.splitlines()
        counts = {op: sum(f" {op}." in ln or f" {op} " in ln for ln in sass)
                  for op in ("HMMA", "HGMMA")}
        log(f"{name}: SASS tensor-core instructions {counts} "
            f"({len(sass)} SASS lines)")


# ------------------------------------------------------------ phase 3 ----
def time_ms(fn, reps=20, warmup=3):
    """Device time of one call: ``reps`` calls back to back between two
    CUDA events, after ``warmup`` calls, over the count. The host
    enqueues ahead of the card, so a wrapper's Python time hides behind
    the kernels unless it is the longer of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, kernel, reps=20, tries=3):
    """Device time per launch of the CUDA kernel named ``kernel`` over
    ``reps`` calls of ``fn``, from a ``torch.profiler`` trace of the card:
    no host time in it, whichever side is the slower. A trace sometimes
    comes back without device times; up to ``tries`` traces are taken.
    None when none holds device time for that kernel."""
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(rf"\b{kernel}\b")
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if pat.search(e.key)]
        count = sum(e.count for e in hits)
        total_us = sum(e.device_time_total for e in hits)
        if count and total_us:
            return total_us / count / 1e3
    return None


def library_device_ms(fn):
    """Device time of one call of a PyTorch library ``fn``: every CUDA
    kernel it launches, from a ``torch.profiler`` trace (``device_profile``);
    None when no trace holds device time."""
    prof = device_profile(fn)
    return sum(prof.values()) if prof else None


def single_call_ms(fn, reps=20):
    """Median over ``reps`` single calls, each between two CUDA events: the
    method of the earlier runs, whose interval also holds the wrapper's
    host time before the launch (the card idles through it)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _row_bytes(k, hd, scaled=True):
    """Bytes of one K/V row at one position: hd elements, and an int8
    cache's fp32 row scale (1 B a code plus 4 B a row-position scale;
    ``scaled=False``: the share_values clustered V codes, which have
    none)."""
    return hd * k.element_size() + (
        4 if k.dtype == torch.int8 and scaled else 0)


def _side_bytes(k, hd, scaled):
    """Bytes of one row of a side of a K/V pairing at one position: its
    elements, and 4 B of row scale when it has one, whatever its type."""
    return hd * k.element_size() + (4 if scaled else 0)


def fused_decode_bound(q, k, v, h2c, pos, rpg, tables=(), share=False,
                       softcap=False, k_scaled=None, v_scaled=None):
    """Least time for the work these inputs need: K rows of reps that
    have members and every head's V row, positions 0..pos, read once
    (``k``/``v`` give the element size and the V row count: a dense cache
    or a page pool; int8 rows with their scales, ``_row_bytes``); q, h2c,
    pos and the block ``tables`` read and the (B, H, hd) fp32 output
    written once; the QK and AV multiply-adds in fp32. ``share``
    (share_values): the V rows are the reps' (those with members, as the
    K rows), int8 V codes without scales, and AV runs once per rep.
    ``softcap``: three more fp32 operations a score (a division, a tanh
    counted as one, a product). ``k_scaled``/``v_scaled``: whether each
    side has row scales (a K/V pairing; None: the int8 cache's rule)."""
    b, _, hd = q.shape
    h = h2c.shape[1]
    row = (_row_bytes(k, hd) if k_scaled is None
           else _side_bytes(k, hd, k_scaled))
    v_row = (_row_bytes(v, hd, scaled=not share) if v_scaled is None
             else _side_bytes(v, hd, v_scaled))
    n_bytes = (q.numel() + h2c.numel() + pos.numel() + b * h * hd
               + sum(t.numel() for t in tables)) * 4
    flops = 0
    for i in range(b):
        n = int(pos[i]) + 1
        k_rows = len({int(j) // rpg for j in h2c[i].tolist()})
        reps = len(set(h2c[i].tolist()))
        n_bytes += k_rows * n * row + (reps if share else v.shape[1]) * n \
            * v_row
        flops += 2 * (reps + (reps if share else h)) * n * hd
        if softcap:
            flops += 3 * reps * n
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_decode_case(q, k, v, h2c, pos, *, rpg, ts, **scales):
    """Kernel vs plain on one input (``scales``: an int8 cache's k_scale
    and v_scale, and ``share_values``); returns (max_abs_err, ms,
    plain_ms)."""
    out = ck.chai_fused_decode(q, k, v, h2c, pos, reps_per_group=rpg, ts=ts,
                               **scales)
    torch.cuda.synchronize()
    want = kref.chai_fused_decode_ref(q, k, v, h2c, pos, reps_per_group=rpg,
                                      **scales)
    torch.cuda.synchronize()
    if out.shape != want.shape or not torch.isfinite(out).all():
        raise AssertionError(f"kernel output {tuple(out.shape)} not finite "
                             "or of the wrong shape")
    err = float((out - want).abs().max())
    torch.testing.assert_close(out, want, **TOL)
    ms = time_ms(lambda: ck.chai_fused_decode(q, k, v, h2c, pos,
                                              reps_per_group=rpg, ts=ts,
                                              **scales))
    plain_ms = time_ms(lambda: kref.chai_fused_decode_ref(
        q, k, v, h2c, pos, reps_per_group=rpg, **scales))
    return err, ms, plain_ms


def synthetic_case(gen, *, b, h, kv, rpg, s, hd, dtype, empty_rep):
    dev = "cuda"
    r = kv * rpg
    q = torch.randn(b, r, hd, generator=gen, device=dev)
    k = torch.randn(b, kv, s, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, kv if rpg > 1 else h, s, hd, generator=gen,
                    device=dev).to(dtype)
    pos = torch.randint(300, 1001, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    if rpg == 1:
        choices = torch.tensor([j for j in range(r) if j != empty_rep],
                               device=dev, dtype=torch.int32)
        h2c = choices[torch.randint(0, len(choices), (b, h), generator=gen,
                                    device=dev)]
    else:
        group = torch.arange(h, device=dev) // (h // kv)
        h2c = (group[None] * rpg + torch.randint(
            0, rpg, (b, h), generator=gen, device=dev)).to(torch.int32)
    return q, k, v, h2c, pos


def kernel_checks():
    gen = torch.Generator("cuda").manual_seed(1)
    full = get_config(ARCH)
    cases = []
    for name, kw in (
            ("mha_fp32", dict(b=4, h=32, kv=full.k_max, rpg=1,
                              dtype=torch.float32, empty_rep=7)),
            ("mha_bf16", dict(b=4, h=32, kv=full.k_max, rpg=1,
                              dtype=torch.bfloat16, empty_rep=7)),
            ("gqa_bf16", dict(b=4, h=48, kv=8, rpg=2,
                              dtype=torch.bfloat16, empty_rep=None))):
        q, k, v, h2c, pos = synthetic_case(gen, s=MAX_SEQ, hd=128, **kw)
        err, ms, plain_ms = fused_decode_case(q, k, v, h2c, pos,
                                              rpg=kw["rpg"], ts=PAGE)
        bound, by = fused_decode_bound(q, k, v, h2c, pos, kw["rpg"])
        cases.append(dict(case=name, q=list(q.shape), k=list(k.shape),
                          v=list(v.shape), dtype=str(k.dtype), ts=PAGE,
                          pos=pos.tolist(), max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by))
        log(f"chai_fused_decode {name}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} max_abs_err {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound:.4f} "
            f"ms ({by})")
    return cases


def to_pages(gen, x, n_extra=7, scale=None):
    """Dense (B, rows, S, hd) -> (pool, block table): every row's pages
    at shuffled ids of a pool whose other pages hold random values. With
    ``scale`` (B, rows, S), an int8 cache's scales: also its scale pool
    (nP, rows, page), the same pages at the same ids."""
    b, rows, s, hd = x.shape
    n = s // PAGE
    n_pool = b * n + n_extra
    pool = torch.randn((n_pool, rows, PAGE, hd), generator=gen,
                       device="cuda").to(x.dtype)
    ids = torch.randperm(n_pool - 1, generator=gen, device="cuda")[:b * n]
    bt = (ids + 1).reshape(b, n).to(torch.int32)
    pool[bt.long()] = x.reshape(b, rows, n, PAGE, hd).movedim(2, 1)
    if scale is None:
        return pool, bt
    spool = torch.rand((n_pool, rows, PAGE), generator=gen, device="cuda")
    spool[bt.long()] = scale.reshape(b, rows, n, PAGE).movedim(2, 1)
    return pool, bt, spool


def paged_decode_case(q, k_pool, bt_k, v_pool, bt_v, h2c, pos, *, rpg,
                      k_scale_pool=None, v_scale_pool=None,
                      share_values=False, softcap=0.0):
    """Paged kernel vs its plain version and, bitwise, vs the dense
    kernel on the densified pools (and int8 scale pools) at tile = page;
    returns (max_abs_err, ms, plain_ms)."""
    args = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
    pools = dict(k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
                 share_values=share_values, softcap=softcap)
    out = ck.paged_chai_fused_decode(*args, reps_per_group=rpg, **pools)
    torch.cuda.synchronize()
    want = kref.paged_chai_fused_decode_ref(*args, reps_per_group=rpg,
                                            **pools)
    if out.shape != want.shape or not torch.isfinite(out).all():
        raise AssertionError(f"paged kernel output {tuple(out.shape)} not "
                             "finite or of the wrong shape")
    err = float((out - want).abs().max())
    torch.testing.assert_close(out, want, **TOL)
    scales = {name: kref.gather_pages_ref(t, bt)
              for name, t, bt in (("k_scale", k_scale_pool, bt_k),
                                  ("v_scale", v_scale_pool, bt_v))
              if t is not None}
    dense = ck.chai_fused_decode(
        q, kref.gather_pages_ref(k_pool, bt_k),
        kref.gather_pages_ref(v_pool, bt_v), h2c, pos, reps_per_group=rpg,
        ts=k_pool.shape[2], share_values=share_values, softcap=softcap,
        **scales)
    torch.cuda.synchronize()
    if not torch.equal(out, dense):
        raise AssertionError("paged kernel differs from the dense kernel "
                             "at page = tile: max abs diff "
                             f"{float((out - dense).abs().max()):.3e}")
    ms = time_ms(lambda: ck.paged_chai_fused_decode(*args, reps_per_group=rpg,
                                                    **pools))
    plain_ms = time_ms(lambda: kref.paged_chai_fused_decode_ref(
        *args, reps_per_group=rpg, **pools))
    return err, ms, plain_ms


def paged_kernel_checks():
    gen = torch.Generator("cuda").manual_seed(2)
    full = get_config(ARCH)
    cases = []
    for name, kw, warmup_row in (
            ("paged_mha_fp32", dict(b=4, h=32, kv=full.k_max, rpg=1,
                                    dtype=torch.float32, empty_rep=7), None),
            ("paged_mha_bf16", dict(b=4, h=32, kv=full.k_max, rpg=1,
                                    dtype=torch.bfloat16, empty_rep=7),
             None),
            ("paged_mha_bf16_warmup_row", dict(
                b=4, h=32, kv=full.k_max, rpg=1, dtype=torch.bfloat16,
                empty_rep=7), 1),
            ("paged_gqa_bf16", dict(b=4, h=48, kv=8, rpg=2,
                                    dtype=torch.bfloat16, empty_rep=None),
             None)):
        q, k, v, h2c, pos = synthetic_case(gen, s=MAX_SEQ, hd=128, **kw)
        k_pool, bt_k = to_pages(gen, k)
        v_pool, bt_v = to_pages(gen, v)
        if warmup_row is not None:
            # a WARMUP slot in a mixed step: all-null K table, every head
            # in cluster 0
            bt_k[warmup_row] = 0
            h2c[warmup_row] = 0
        err, ms, plain_ms = paged_decode_case(
            q, k_pool, bt_k, v_pool, bt_v, h2c, pos, rpg=kw["rpg"])
        bound, by = fused_decode_bound(q, k_pool, v_pool, h2c, pos,
                                       kw["rpg"], tables=(bt_k, bt_v))
        cases.append(dict(case=name, q=list(q.shape),
                          k_pool=list(k_pool.shape),
                          v_pool=list(v_pool.shape), dtype=str(k.dtype),
                          page=PAGE, pos=pos.tolist(), max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, bitwise_equal_dense=True))
        log(f"paged_chai_fused_decode {name}: q {tuple(q.shape)} k_pool "
            f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} "
            f"max_abs_err {err:.3e} (bitwise = dense kernel) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound:.4f} ms "
            f"({by})")
    return cases


def _max_err(got, want):
    """Largest |got - want| over a tensor or a state triple."""
    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def _hold(got, want, tol=TOL):
    """Shapes, finiteness (a state's m may hold the identity's -2e38,
    which is finite) and ``tol``; returns the max abs error."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"kernel output {tuple(g.shape)} not "
                                 f"finite or not of the plain version's "
                                 f"shape {tuple(w.shape)}")
        torch.testing.assert_close(g.float(), w.float(), **tol)
    return _max_err(got, want)


def _visible_pairs(t, s, offset, window=0):
    """(query, key) pairs a causal prefill computes: query offset + i sees
    keys 0..offset + i below S, only the last ``window`` of them when
    window > 0."""
    n = 0
    for i in range(t):
        hi = min(s, offset + i + 1)
        n += max(0, hi - (max(0, offset + i - window + 1) if window else 0))
    return n


def flash_prefill_bound(q, k, offset, emit_state, window=0, softcap=False):
    """Least time for ``flash_prefill``'s work: q read once, the K and V
    rows some query sees read once (all of them without a window), the
    output (q's dtype) or the fp32 state written once; the QK and PV
    multiply-adds of the visible pairs (query offset + t sees keys
    0..offset + t, the last ``window`` of them with a window) at the
    inputs' peak rate (bf16 tensor cores, or fp32), and with ``softcap``
    three fp32 operations a visible score (a division, a tanh counted as
    one, a product) on the CUDA cores."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    es = q.element_size()
    k_first = max(0, offset - window + 1) if window else 0
    k_rows = max(0, min(s, offset + t) - k_first)
    n_bytes = (q.numel() + 2 * b * k_rows * kv * hd) * es + 4
    n_bytes += (2 * b * h * t + b * h * t * hd) * 4 if emit_state else (
        q.numel() * es)
    pairs = _visible_pairs(t, s, offset, window)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (4 * b * h * hd * pairs / peak
             + (3 * b * h * pairs / FP32_FLOPS if softcap else 0)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def prefix_bound(q, pool, bt_k, plen, scaled, softcap=False):
    """Least time for ``paged_prefix_attend``'s work: q, the K and V rows
    of the positions < plen (with their scales where ``scaled``, (K's,
    V's), says, ``_side_bytes``) and the table entries of their pages
    read once, the fp32 state written once; 4 * hd flops per (query,
    head, position) at the queries' peak rate, and with ``softcap`` three
    fp32 operations a score on the CUDA cores."""
    b, t, h, hd = q.shape
    kv, page = pool.shape[1], pool.shape[2]
    es = q.element_size()
    rows = sum(_side_bytes(pool, hd, x) for x in scaled)
    lens = [min(int(n), bt_k.shape[1] * page) for n in plen.tolist()]
    n_bytes = (q.numel() * es + sum(n * kv * rows for n in lens)
               + sum(2 * 4 * -(-n // page) for n in lens) + 4 * b
               + (2 * b * h * t + b * h * t * hd) * 4)
    flops = sum(4 * h * hd * t * n for n in lens)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / peak + (sum(3 * h * t * n for n in lens) / FP32_FLOPS
                             if softcap else 0)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_case(q, k, v, *, offset=0, emit_state=True, library=False,
               window=0, softcap=0.0):
    """``flash_prefill`` against its plain version on one input (2e-5,
    or one bf16 step for a finalized bf16 output), in the ``window`` and
    ``softcap`` modes when set; returns the case's record with its times
    and bound. ``library``: also time PyTorch's
    ``scaled_dot_product_attention`` (causal, or with the band mask of
    the window; ``enable_gqa`` when KV < H) beside the finalized mode on
    the same inputs, whose every row must see a key (SDPA has no tanh
    softcap: a softcap case has no library call)."""
    mode = dict(offset=offset, window=window, softcap=softcap)
    got = fk.flash_prefill(q, k, v, emit_state=emit_state, **mode)
    torch.cuda.synchronize()
    if emit_state:
        want, tol = kref.flash_prefill_state_ref(q, k, v, **mode), TOL
    else:
        if got.dtype != q.dtype:
            raise AssertionError(f"finalized output in {got.dtype}")
        want = kref.flash_prefill_ref(q, k, v, **mode)
        tol = TOL if q.dtype == torch.float32 else BF16_OUT_TOL
    err = _hold(got, want, tol)
    call = lambda: fk.flash_prefill(  # noqa: E731
        q, k, v, emit_state=emit_state, **mode)
    ms = time_ms(call)
    plain = (kref.flash_prefill_state_ref if emit_state
             else kref.flash_prefill_ref)
    plain_ms = time_ms(lambda: plain(q, k, v, **mode))
    bound, by = flash_prefill_bound(q, k, offset, emit_state, window,
                                    bool(softcap))
    rec = dict(q=list(q.shape), k=list(k.shape), dtype=str(q.dtype),
               offset=offset, emit_state=emit_state, max_abs_err=err,
               tolerance="2e-5" if tol is TOL else "one bf16 step",
               ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    if window or softcap:
        rec.update(window=window, softcap=softcap)
    if library and not softcap:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        gqa = k.shape[2] != q.shape[2]
        t, s = q.shape[1], k.shape[1]
        qp = offset + torch.arange(t, device=q.device)[:, None]
        kp = torch.arange(s, device=q.device)[None, :]
        band = (kp <= qp) & (qp - kp < window) if window else None

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=band, is_causal=band is None,
                enable_gqa=gqa)
        lib = sdpa().transpose(1, 2)
        fin = fk.flash_prefill(q, k, v, **mode)
        rec["library_ms"] = time_ms(sdpa)
        rec["library_device_ms"] = library_device_ms(sdpa)
        rec["finalized_ms"] = time_ms(lambda: fk.flash_prefill(q, k, v,
                                                               **mode))
        rec["library_vs_kernel_max_abs_diff"] = _max_err(lib, fin)
    if library:
        rec["device_ms"] = device_ms(call, "flash_prefill_kernel")
        rec["single_call_ms"] = single_call_ms(call)
    return rec


def prefix_case(q, pool, bt_k, bt_v, plen, softcap=0.0, v_unit=1.0,
                **scale_pools):
    """``paged_prefix_attend`` against its plain version (2e-5), capped at
    ``softcap`` when set; rows with plen == 0 must hold the merge
    identity exactly (``scale_pools``: the pool's k_scale_pool and
    v_scale_pool, each optional). ``v_unit``: acc held over V's range (a
    raw int8 V side: 127), the raw error recorded beside it. Returns the
    record."""
    if softcap:
        scale_pools = dict(scale_pools, softcap=softcap)
    got = fk.paged_prefix_attend(q, pool, bt_k, bt_v, plen, **scale_pools)
    torch.cuda.synchronize()
    want = kref.paged_prefix_attend_ref(q, pool, bt_k, bt_v, plen,
                                        **scale_pools)
    extra = {}
    if v_unit != 1:
        extra = dict(held=f"acc / {v_unit:g}", raw_max_abs_err=_max_err(
            got, want))
        err = _hold(*(((m, l, acc / v_unit) for m, l, acc in (got, want))))
    else:
        err = _hold(got, want)
    empty = plen == 0
    if empty.any():
        m, l, acc = (x[empty] for x in got)
        if not ((m == kref.NEG_INF).all() and (l == 0).all()
                and (acc == 0).all()):
            raise AssertionError("paged_prefix_attend: a plen == 0 row is "
                                 "not the merge identity")
    ms = time_ms(lambda: fk.paged_prefix_attend(q, pool, bt_k, bt_v, plen,
                                                **scale_pools))
    plain_ms = time_ms(lambda: kref.paged_prefix_attend_ref(
        q, pool, bt_k, bt_v, plen, **scale_pools))
    bound, by = prefix_bound(q, pool, bt_k, plen, tuple(
        scale_pools.get(f"{x}_scale_pool") is not None for x in "kv"),
        bool(softcap))
    return dict(q=list(q.shape), pool=list(pool.shape), dtype=str(q.dtype),
                pool_dtype=str(pool.dtype),
                plen=plen.tolist(), identity_rows=int(empty.sum()),
                max_abs_err=err, **extra, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


def _log_case(name, case):
    log(f"{name} {case['case']}: q {tuple(case['q'])} {case['dtype']} "
        + (f"plen {case['plen']} " if "plen" in case else
           f"offset {case['offset']} emit_state {case['emit_state']} ")
        + f"max_abs_err {case['max_abs_err']:.3e} kernel {case['ms']:.4f} "
        f"ms plain {case['plain_ms']:.4f} ms bound {case['bound_ms']:.4f} ms"
        f" ({case['bound_by']})"
        + (f" device {case['device_ms']} ms against the plain mode's "
           f"{case['plain_mode_device_ms']} ms"
           if "plain_mode_device_ms" in case else "")
        + (f" library {case['library_ms']:.4f} ms, device "
           f"{case['library_device_ms']} ms (kernel finalized "
           f"{case['finalized_ms']:.4f} ms; kernel device "
           f"{case['device_ms']} ms)" if "library_ms" in case else ""))


def prefill_kernel_checks():
    """Both prefill kernels at a full chunk's shapes (T = 128 queries of 32
    heads of 128, a pool of 513 pages of 16) and at the edges."""
    gen = torch.Generator("cuda").manual_seed(3)
    dev = "cuda"

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    flash = []
    cases = {
        "chunk_bf16_state": (128, 128, 32, 32, torch.bfloat16, 0, True,
                             False),
        "chunk_bf16_finalized": (128, 128, 32, 32, torch.bfloat16, 0,
                                 False, True),
        "chunk_fp32_state": (128, 128, 32, 32, torch.float32, 0, True,
                             False),
        "chunk_fp32_finalized": (128, 128, 32, 32, torch.float32, 0,
                                 False, False),
        "offset384_bf16_state": (128, 512, 32, 32, torch.bfloat16, 384,
                                 True, False),
        "ragged_t40_offset60_fp32": (40, 100, 32, 32, torch.float32, 60,
                                     True, False),
        "gqa_h48_kv8_bf16_state": (128, 128, 48, 8, torch.bfloat16, 0,
                                   True, True)}
    # T = 128 at offset 384 over S = 512, MHA and GQA, bf16 and fp32, each
    # finalized and as state; a ragged T that is no multiple of the query
    # tile (16 rows a warp, PREFILL_QUERY_WARPS warps a block).
    for attn, (h, kv) in (("mha", (32, 32)), ("gqa", (48, 8))):
        for dtype in (torch.bfloat16, torch.float32):
            for emit in (True, False):
                name = (f"offset384_{attn}_{str(dtype)[6:]}_"
                        f"{'state' if emit else 'finalized'}")
                cases[name] = (128, 512, h, kv, dtype, 384, emit, False)
    for emit in (True, False):
        cases[f"ragged_t77_offset200_gqa_bf16_"
              f"{'state' if emit else 'finalized'}"] = (
            77, 277, 48, 8, torch.bfloat16, 200, emit, False)
    for name, (t, s, h, kv, dtype, offset, emit, lib) in cases.items():
        q = rand(1, t, h, 128, dtype=dtype)
        k, v = rand(1, s, kv, 128, dtype=dtype), rand(1, s, kv, 128,
                                                      dtype=dtype)
        case = dict(case=name, **flash_case(q, k, v, offset=offset,
                                            emit_state=emit, library=lib))
        flash.append(case)
        _log_case("flash_prefill", case)
    # a device tensor offset gives the int offset's bits
    q, k, v = rand(1, 128, 32, 128), rand(1, 512, 32, 128), rand(1, 512, 32,
                                                                  128)
    a = fk.flash_prefill(q, k, v, offset=384, emit_state=True)
    b = fk.flash_prefill(q, k, v, offset=torch.tensor([384], device=dev),
                         emit_state=True)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("flash_prefill: tensor offset differs from int")

    prefix = []
    n_pool, p_slot = 2 * SLOTS * MAX_SEQ // PAGE + 1, MAX_SEQ // PAGE
    for name, (b, h, kv, dtype, plens) in {
            "plen128_bf16": (1, 32, 32, torch.bfloat16, (128,)),
            "plen256_bf16": (1, 32, 32, torch.bfloat16, (256,)),
            "plen384_bf16": (1, 32, 32, torch.bfloat16, (384,)),
            "plen0_bf16": (1, 32, 32, torch.bfloat16, (0,)),
            "rows_0_200_384_bf16": (3, 32, 32, torch.bfloat16, (0, 200, 384)),
            "plen384_fp32": (1, 32, 32, torch.float32, (384,)),
            "gqa_h48_kv8_plen384_bf16": (1, 48, 8, torch.bfloat16,
                                         (384,))}.items():
        pool = rand(n_pool, kv, PAGE, 128, dtype=dtype)
        ids = (torch.randperm(n_pool - 1, generator=gen, device=dev)
               + 1).to(torch.int32)
        bt_k = ids[:b * p_slot].reshape(b, p_slot)
        bt_v = ids[b * p_slot:2 * b * p_slot].reshape(b, p_slot)
        plen = torch.tensor(plens, dtype=torch.int32, device=dev)
        q = rand(b, 128, h, 128, dtype=dtype)
        case = dict(case=name, **prefix_case(q, pool, bt_k, bt_v, plen))
        prefix.append(case)
        _log_case("paged_prefix_attend", case)
        del pool
    return flash, prefix


def _identity_state(b, r, h, hd):
    """The empty decode state: the exact merge identity (``h`` acc rows:
    the heads, or the reps under share_values)."""
    return (torch.full((b, r), kref.NEG_INF, device="cuda"),
            torch.zeros((b, r), device="cuda"),
            torch.zeros((b, h, hd), device="cuda"))


def emit_state_checks():
    """Both decode kernels' ``emit_state`` mode at the continuous path's
    shapes (B = 4, R = k_max = 25, H = 32, S = 1024, page 16, a rep with
    no member head): each against its plain version at 2e-5; paged ==
    dense bitwise; and emit + merge with the identity + finalize equal
    to the finalized launch bit for bit."""
    gen = torch.Generator("cuda").manual_seed(4)
    full = get_config(ARCH)
    cases = {"chai_fused_decode": [], "paged_chai_fused_decode": []}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, h2c, pos = synthetic_case(
            gen, b=4, h=32, kv=full.k_max, rpg=1, s=MAX_SEQ, hd=128,
            dtype=dtype, empty_rep=7)
        k_pool, bt_k = to_pages(gen, k)
        v_pool, bt_v = to_pages(gen, v)
        pa = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
        dense = ck.chai_fused_decode(q, k, v, h2c, pos, ts=PAGE,
                                     emit_state=True)
        paged = ck.paged_chai_fused_decode(*pa, emit_state=True)
        fin_dense = ck.chai_fused_decode(q, k, v, h2c, pos, ts=PAGE)
        fin_paged = ck.paged_chai_fused_decode(*pa)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(paged, dense)):
            raise AssertionError("emit_state: paged kernel differs from the "
                                 "dense kernel at page = tile")
        ident = _identity_state(4, full.k_max, 32, 128)
        for st, fin, label in ((dense, fin_dense, "dense"),
                               (paged, fin_paged, "paged")):
            merged = kops.finalize_decode_state(
                kops.merge_decode_states(st, ident, h2c), h2c)
            if not torch.equal(merged, fin):
                raise AssertionError(
                    f"emit_state {label}: emit + identity merge + finalize "
                    "differs from the finalized launch: max abs diff "
                    f"{float((merged - fin).abs().max()):.3e}")
        for name, got, want, call, plain in (
                ("chai_fused_decode", dense,
                 kref.chai_fused_decode_ref(q, k, v, h2c, pos,
                                            emit_state=True),
                 lambda: ck.chai_fused_decode(q, k, v, h2c, pos, ts=PAGE,
                                              emit_state=True),
                 lambda: kref.chai_fused_decode_ref(q, k, v, h2c, pos,
                                                    emit_state=True)),
                ("paged_chai_fused_decode", paged,
                 kref.paged_chai_fused_decode_ref(*pa, emit_state=True),
                 lambda: ck.paged_chai_fused_decode(*pa, emit_state=True),
                 lambda: kref.paged_chai_fused_decode_ref(
                     *pa, emit_state=True))):
            err = _hold(got, want)
            kk, vv = (k, v) if name == "chai_fused_decode" else (k_pool,
                                                                 v_pool)
            bound, by = fused_decode_bound(q, kk, vv, h2c, pos, 1)
            if by == "bytes":   # the state mode writes m and l (B, R) too
                bound += 2 * q.numel() // q.shape[2] * 4 / HBM_BYTES_PER_S \
                    * 1e3
            case = dict(case=f"emit_state_{str(dtype)[6:]}", emit_state=True,
                        q=list(q.shape), dtype=str(dtype), pos=pos.tolist(),
                        max_abs_err=err, ms=time_ms(call),
                        plain_ms=time_ms(plain), bound_ms=bound, bound_by=by,
                        bitwise_equal_dense=True,
                        identity_merge_finalize_equal=True)
            cases[name].append(case)
            log(f"{name} {case['case']}: max_abs_err {err:.3e}, kernel "
                f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                f"bound {bound:.4f} ms; paged == dense bitwise, emit + "
                "identity merge + finalize == finalized launch bitwise")
    return cases


def relay_bound(q, k, v, k_row, a_row, v_row, plen, k_scaled, v_scaled,
                softcap=False):
    """Least time for ``relay_prefix_decode``'s work: per group the K rows
    its query rows name and the V rows its acc rows name, positions <
    plen, read once (``kops.relay_prefix_hbm_bytes_estimate`` over the
    distinct rows, each side's with its fp32 row scales where
    ``k_scaled`` / ``v_scaled`` say: the share_values relay's int8 V has
    none); q, the maps and plen read and the fp32 state (m, l and acc)
    written once; the QK and AV multiply-adds in fp32, and with
    ``softcap`` three fp32 operations a score."""
    g, nr, hd = q.shape
    a = a_row.shape[1]
    n_bytes = (q.numel() + k_row.numel() + a_row.numel() + v_row.numel()
               + plen.numel() + 2 * g * nr + g * a * hd) * 4
    flops = 0
    for i in range(g):
        n = int(plen[i])
        n_bytes += kops.relay_prefix_hbm_bytes_estimate(
            len(set(k_row[i].tolist())), 0, n, hd,
            cache_bytes=k.element_size(), int8_scales=k_scaled)
        n_bytes += kops.relay_prefix_hbm_bytes_estimate(
            0, len(set(v_row[i].tolist())), n, hd,
            cache_bytes=v.element_size(), int8_scales=v_scaled)
        flops += 2 * (nr + a) * n * hd + (3 * nr * n if softcap else 0)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def relay_plan(q, k, v, k_row, a_row, v_row, ts):
    """The relay kernel's cut of one call (``ck.relay_launch_config``) and
    the prefix rows its blocks stream against the distinct rows the bound
    counts (``ck.relay_units``, the kernel's routing): a score block
    streams its K row once, a sum block its V row once."""
    g, nr, hd = q.shape
    sp = k.shape[2]
    ts = ck.fused_tile_size(ts, sp)
    cfg = ck.relay_launch_config(g, nr, a_row.shape[1], k.shape[1],
                                 v.shape[1], sp // ts)
    units = ck.relay_units(k_row, a_row, v_row)
    scores = sum(len(u["scores"]) for u in units)
    sums = sum(len(u["sums"]) for u in units)
    return dict(
        score_units=scores, sum_units=sums, q_slots=cfg.q_slots,
        v_slots=cfg.v_slots, n_split=cfg.n_split,
        tiles_per_split=cfg.tiles_per_split,
        blocks=(cfg.q_slots + cfg.v_slots) * cfg.n_split * g,
        k_row_reads=scores, k_rows=sum(len(set(r.tolist())) for r in k_row),
        v_row_reads=sums, v_rows=sum(len(set(r.tolist())) for r in v_row),
        smem_bytes=cfg.smem_bytes)


def _per_l(state, a_row):
    """A relay state with each acc row over its query row's l: the
    quantity the merge and the finalize carry on, at the scale of one
    attention output."""
    m, l, acc = state
    return m, l, acc / torch.gather(l, 1, a_row.long())[..., None]


def _share_per_l(state):
    """A share_values decode state (acc rows: the reps) with each acc row
    over its own l. Its raw sums round apart by ~1e-7 of l between two
    summation orders, which over raw int8 V codes (up to 127) or tens of
    thousands of positions exceeds 2e-5; over l it is one output's
    scale."""
    m, l, acc = state
    return m, l, acc / torch.clamp(l, min=1e-37)[..., None]


def relay_case(q, k, v, k_row, a_row, v_row, plen, ts, *, per_l=False,
               v_unit=1.0, k_scale=None, v_scale=None, softcap=0.0):
    """``relay_prefix_decode`` against its plain version (2e-5) and
    launched twice with equal bits; returns the case's record with its
    plan, rows streamed, times and bound. ``per_l``: hold each acc row
    over its l (and record the raw acc's error): over tens of thousands of
    positions the raw acc and l are sums of that many terms of up to 1,
    which two summation orders round apart by ~1e-7 of l; ``v_unit``: and
    over the V values' range (raw int8 codes: 127), so that 2e-5 is of the
    range as it is of a unit V's. ``k_scale``/``v_scale``: an int8 view's
    scale planes; ``softcap``: the mode."""
    args = (q, k, v, k_row, a_row, v_row, plen)
    sc = dict(k_scale=k_scale, v_scale=v_scale)
    if softcap:
        sc["softcap"] = softcap
    got = ck.relay_prefix_decode(*args, ts=ts, **sc)
    again = ck.relay_prefix_decode(*args, ts=ts, **sc)
    torch.cuda.synchronize()
    _bitwise("relay_prefix_decode: two launches", again, got)
    want = kref.relay_prefix_decode_ref(*args, **sc)
    if per_l:
        raw_err = _max_err(got, want)
        got, want = _per_l(got, a_row), _per_l(want, a_row)
        per_l_err = _max_err(got, want)
        got, want = ((m, l, acc / v_unit) for m, l, acc in (got, want))
    err = _hold(got, want)
    bound, by = relay_bound(q, k, v, k_row, a_row, v_row, plen,
                            k_scale is not None, v_scale is not None,
                            softcap=bool(softcap))
    lib_smem = build.load("relay_prefix_decode").relay_smem_bytes()
    plan = relay_plan(q, k, v, k_row, a_row, v_row, ts)
    if lib_smem != plan["smem_bytes"]:
        raise AssertionError(f"relay: the kernel's block takes {lib_smem} B "
                             "of shared memory, the host's mirror says "
                             f"{plan['smem_bytes']}")
    extra = dict(held="acc / l" + (f" / {v_unit:g}" if v_unit != 1 else ""),
                 raw_max_abs_err=raw_err,
                 per_l_max_abs_err=per_l_err) if per_l else {}
    call = lambda: ck.relay_prefix_decode(*args, ts=ts, **sc)  # noqa: E731
    return dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                a=a_row.shape[1], dtype=str(k.dtype), ts=ts,
                plen=plen.tolist(), max_abs_err=err, **extra,
                repeat_bitwise=True, plan=plan, ms=time_ms(call),
                device_ms=device_ms(call, "relay_prefix_decode_kernel",
                                    reps=5 if per_l else 20),
                plain_ms=time_ms(lambda: kref.relay_prefix_decode_ref(
                    *args, **sc)),
                bound_ms=bound, bound_by=by)


def _log_relay(case):
    p = case["plan"]
    log(f"relay_prefix_decode {case['case']}: q {tuple(case['q'])} k "
        f"{tuple(case['k'])} A {case['a']} plen {case['plen']}: max_abs_err"
        f" {case['max_abs_err']:.3e}"
        + (f" ({case['held']}; acc / l {case['per_l_max_abs_err']:.3e};"
           f" raw state {case['raw_max_abs_err']:.3e})"
           if "held" in case else "")
        + f", two launches bitwise; plan {p['score_units']} score units "
        f"in {p['q_slots']} slots and {p['sum_units']} sum units in "
        f"{p['v_slots']} slots x {p['n_split']} splits of "
        f"{p['tiles_per_split']} tiles = {p['blocks']} blocks; rows "
        f"streamed K {p['k_row_reads']} / "
        f"{p['k_rows']} distinct, V {p['v_row_reads']} / {p['v_rows']} "
        f"distinct; kernel {case['ms']:.4f} ms back to back, device "
        f"{case['device_ms']} ms, plain {case['plain_ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms ({case['bound_by']})")


def relay_maps(gen, members, nmax, *, gqa):
    """Routing maps as the engine builds them (``serving.engine.
    _relay_row_maps``) for groups of ``members`` real slots of ``nmax``;
    padded entries stay 0. MHA (chai-llama-7b: R = 25 reps of H = 32
    heads, K and V rows per head): query row j*R + i reads K row reps[i],
    head h reads query row j*R + h2c[h] (one rep without a head) and V row
    h. GQA (nemotron-4-15b: 8 KV groups of 5 reps and 6 heads, R = 40, H =
    48): query row j*R + c*5 + i reads K row c, so 4 x 5 = 20 query rows
    of a full group read each K row; head h of KV group c reads query row
    j*R + c*5 + (its cluster) and V row c. Returns (k_row, a_row, v_row,
    R, K rows, V rows)."""
    dev = "cuda"
    if gqa:
        n_kv, r_g, qpk = 8, 5, 6
        r, h, kv, vr = n_kv * r_g, n_kv * qpk, n_kv, n_kv
    else:
        r, h = get_config(ARCH).k_max, 32
        kv = vr = h
    g = len(members)
    k_row = torch.zeros(g, nmax * r, dtype=torch.int32, device=dev)
    a_row = torch.zeros(g, nmax * h, dtype=torch.int32, device=dev)
    v_row = torch.zeros(g, nmax * h, dtype=torch.int32, device=dev)
    for i, n_mem in enumerate(members):
        for j in range(n_mem):
            if gqa:
                grp = torch.arange(h, device=dev) // qpk
                k_row[i, j * r:(j + 1) * r] = torch.arange(
                    n_kv, device=dev).repeat_interleave(r_g)
                a_row[i, j * h:(j + 1) * h] = j * r + grp * r_g + (
                    torch.randint(0, r_g, (h,), generator=gen, device=dev))
                v_row[i, j * h:(j + 1) * h] = grp
            else:
                reps = torch.randperm(h, generator=gen, device=dev)[:r]
                h2c = torch.randint(0, r - 1, (h,), generator=gen,
                                    device=dev)
                k_row[i, j * r:(j + 1) * r] = reps
                a_row[i, j * h:(j + 1) * h] = j * r + h2c
                v_row[i, j * h:(j + 1) * h] = torch.arange(h, device=dev)
    return k_row, a_row, v_row, r, kv, vr


def relay_kernel_checks():
    """``relay_prefix_decode`` on synthetic groups at the full-width
    shapes (hd 128; ``relay_maps``; the tail of each group's view past
    plen zero, as the engine's views): G = 2 MHA groups of 4 and 3
    members (the fourth slot of group 1 padded, index 0 in every map; plen
    200 and 256, Sp = 256), bf16 and fp32; one GQA group of 4 members (20
    query rows on each K row); GQA groups of 4 and 3 (the padded slot's 40
    query rows on K row 0 and its 48 acc rows on query row 0, so its unit
    sums its members in several passes); and G = 3 MHA groups at plen
    200, 1024 and 0 in a view of Sp = 1024, whose later splits lie wholly
    past plen (every split of the third)."""
    gen = torch.Generator("cuda").manual_seed(5)
    dev = "cuda"
    hd, nmax = 128, 4
    cases = []
    for tag, dtype, members, plen, sp, gqa in (
            ("synthetic_g2_bfloat16", torch.bfloat16, (4, 3), (200, 256),
             256, False),
            ("synthetic_g2_float32", torch.float32, (4, 3), (200, 256), 256,
             False),
            ("gqa_20_per_k_row_bfloat16", torch.bfloat16, (4,), (256,), 256,
             True),
            ("gqa_group_of_3_in_4_bfloat16", torch.bfloat16, (4, 3),
             (256, 180), 256, True),
            ("splits_past_plen_bfloat16", torch.bfloat16, (4, 3, 2),
             (200, 1024, 0), 1024, False)):
        k_row, a_row, v_row, r, kv, vr = relay_maps(gen, members, nmax,
                                                    gqa=gqa)
        g = len(members)
        plen_t = torch.tensor(plen, dtype=torch.int32, device=dev)
        q = torch.randn(g, nmax * r, hd, generator=gen, device=dev)
        k = torch.randn(g, kv, sp, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(g, vr, sp, hd, generator=gen, device=dev).to(dtype)
        for i, n in enumerate(plen):
            k[i, :, n:] = 0
            v[i, :, n:] = 0
        case = dict(case=tag, **relay_case(q, k, v, k_row, a_row, v_row,
                                           plen_t, PAGE))
        cases.append(case)
        _log_relay(case)
    return cases


# ------------------------------------------ phase 3: split-S decode ----
def _bitwise(name, got, want):
    """``torch.equal`` of two outputs or two state triples, or raise."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    if not all(torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{name}: max abs diff "
                             f"{_max_err(got, want):.3e}")


def fused_pair_case(tag, q, k, v, h2c, pos, *, rpg, gen, null_k_rows=(),
                    k_scale=None, v_scale=None, profile=False, share=False,
                    softcap=0.0, v_unit=1.0):
    """Both fused kernels on one input, the same K/V also on shuffled
    pool pages (rows ``null_k_rows`` with an all-null K table, as a
    WARMUP row of a mixed step): each against the plain version (2e-5),
    paged ``torch.equal`` to dense at page = tile (dense reads the
    densified pools), each launched twice with equal bits, and emit +
    merge with the empty state + finalize equal to the finalized launch
    bit for bit. ``k_scale``/``v_scale``: int8 K/V's row scales (B, rows,
    S), paged beside their codes. ``profile``: also each kernel's device
    time (a ``torch.profiler`` trace) and single-call time. ``share``:
    the share_values mode (v: the clustered V, (B, R, S, hd); int8 V
    codes come without ``v_scale``; a null row's V table is all null too,
    as a WARMUP row's ``bt_vc``). ``softcap``: the softcap mode, and then
    also each kernel's state (emit_state) against the plain version's (m,
    l and the finalized rows), and the capped output unequal to the same
    launch's without the cap. ``v_unit``: the output held over V's range
    (raw int8 V codes: 127), the raw error recorded beside it. Returns
    {kernel: record}."""
    k_pool, bt_k, *ks_pool = to_pages(gen, k, scale=k_scale)
    v_pool, bt_v, *vs_pool = to_pages(gen, v, scale=v_scale)
    ks_pool, vs_pool = (x[0] if x else None for x in (ks_pool, vs_pool))
    for row in null_k_rows:
        bt_k[row] = 0
        if share:
            bt_v[row] = 0
    kd = kref.gather_pages_ref(k_pool, bt_k)
    vd = kref.gather_pages_ref(v_pool, bt_v)
    dense_sc = {name: kref.gather_pages_ref(t, bt)
                for name, t, bt in (("k_scale", ks_pool, bt_k),
                                    ("v_scale", vs_pool, bt_v))
                if t is not None}
    paged_sc = dict(k_scale_pool=ks_pool, v_scale_pool=vs_pool)
    mode = dict(share_values=True) if share else {}
    capkw = dict(softcap=softcap) if softcap else {}
    pa = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
    calls = {
        "chai_fused_decode": lambda emit=False, cap=capkw: (
            ck.chai_fused_decode(q, kd, vd, h2c, pos, reps_per_group=rpg,
                                 ts=PAGE, emit_state=emit, **dense_sc,
                                 **mode, **cap)),
        "paged_chai_fused_decode": lambda emit=False, cap=capkw: (
            ck.paged_chai_fused_decode(*pa, reps_per_group=rpg,
                                       emit_state=emit, **paged_sc, **mode,
                                       **cap))}
    want = kref.paged_chai_fused_decode_ref(*pa, reps_per_group=rpg,
                                            **paged_sc, **mode, **capkw)
    plain = lambda: kref.chai_fused_decode_ref(  # noqa: E731
        q, kd, vd, h2c, pos, reps_per_group=rpg, **dense_sc, **mode,
        **capkw)
    acc_rows = q.shape[1] if share else h2c.shape[1]
    outs, states = {}, {}
    for name, call in calls.items():
        outs[name] = call()
        again = call()
        states[name] = call(True)
        torch.cuda.synchronize()
        _bitwise(f"{tag} {name}: two launches", again, outs[name])
        merged = kops.finalize_decode_state(kops.merge_decode_states(
            states[name], _identity_state(*q.shape[:2], acc_rows,
                                          q.shape[2]), h2c, **mode),
            h2c, **mode)
        _bitwise(f"{tag} {name}: emit + identity merge + finalize vs the "
                 "finalized launch", merged, outs[name])
    _bitwise(f"{tag}: paged vs dense at page = tile",
             outs["paged_chai_fused_decode"], outs["chai_fused_decode"])
    _bitwise(f"{tag}: paged vs dense state",
             states["paged_chai_fused_decode"], states["chai_fused_decode"])
    if share:
        _hold(_share_per_l(states["chai_fused_decode"]),
              _share_per_l(kref.chai_fused_decode_ref(
                  q, kd, vd, h2c, pos, reps_per_group=rpg, emit_state=True,
                  **dense_sc, **mode, **capkw)))
    elif softcap:
        want_st = kref.chai_fused_decode_ref(
            q, kd, vd, h2c, pos, reps_per_group=rpg, emit_state=True,
            **dense_sc, **capkw)
        for name, st in states.items():
            _hold((st[0], st[1], kops.finalize_decode_state(st, h2c)),
                  (want_st[0], want_st[1],
                   kops.finalize_decode_state(want_st, h2c)))
    if softcap:
        for name, call in calls.items():
            if torch.equal(call(cap={}), outs[name]):
                raise AssertionError(f"{tag} {name}: the softcap changed no "
                                     "output bit")
    general = ck.kv_body(k, k_scale, v, v_scale) == ck.KV_GENERAL
    cfg, _ = ck.dense_launch_config(q, kd, h2c, reps_per_group=rpg, ts=PAGE,
                                    share_values=share, general=general)
    lib = ("chai_fused_decode_wide" if q.shape[2] == ck.WIDE_HD
           else "chai_fused_decode")
    lib_smem = build.load(lib).chai_decode_smem_bytes(
        rpg, q.shape[2], h2c.shape[1], cfg.n_cap, int(general))
    if lib_smem != cfg.smem_bytes:
        raise AssertionError(f"{tag}: the kernel's block takes {lib_smem} B "
                             "of shared memory, the host's mirror says "
                             f"{cfg.smem_bytes}")
    plain_ms = time_ms(plain, reps=5, warmup=1)
    recs = {}
    for name, call in calls.items():
        kk, vv, tables = ((kd, vd, ()) if name == "chai_fused_decode"
                          else (k_pool, v_pool, (bt_k, bt_v)))
        bound, by = fused_decode_bound(
            q, kk, vv, h2c, pos, rpg, tables=tables, share=share,
            softcap=bool(softcap), k_scaled=k_scale is not None,
            v_scaled=v_scale is not None)
        recs[name] = dict(
            case=tag, q=list(q.shape), k=list(k.shape), v=list(v.shape),
            dtype=str(k.dtype), page=PAGE, rpg=rpg, pos=pos.tolist(),
            share_values=share, softcap=softcap,
            n_split=cfg.n_split, tiles_per_split=cfg.tiles_per_split,
            smem_bytes=cfg.smem_bytes,
            max_abs_err=_hold(outs[name] / v_unit, want / v_unit),
            **({"held": f"out / {v_unit:g}",
                "raw_max_abs_err": _max_err(outs[name], want)}
               if v_unit != 1 else {}),
            ms=time_ms(call),
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            bitwise_equal_dense=True, repeat_bitwise=True,
            identity_merge_finalize_equal=True)
        if profile:
            recs[name]["device_ms"] = device_ms(call, f"{name}_kernel",
                                                reps=5)
            recs[name]["single_call_ms"] = single_call_ms(call, reps=5)
        r = recs[name]
        log(f"{name} {tag}: q {tuple(q.shape)} k {tuple(k.shape)} rpg "
            f"{rpg} pos {r['pos']} splits {cfg.n_split} x "
            f"{cfg.tiles_per_split} tiles; max_abs_err "
            f"{r['max_abs_err']:.3e}; paged == dense, repeat == repeat, "
            f"emit identity: bitwise; kernel {r['ms']:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {bound:.4f} ms ({by})")
    return recs


def split_decode_checks():
    """The fused decode pair's split-S cases at full width (hd 128, bf16,
    page 16): several splits with a partial last one, all live; rows whose
    splits past the first lie beyond pos (one at pos 0); a WARMUP-like
    row (every head in rep 0, an all-null K table); nemotron's GQA shape
    (48 heads over 8 KV groups, 5 reps each); and one row of S = 65,536,
    above the old shared-memory cap (about 48,800 positions dense), MHA
    and GQA. Then ``relay_prefix_decode`` at Sp = 65,536 against its
    plain version. Returns ({kernel: [records]}, [relay records])."""
    gen = torch.Generator("cuda").manual_seed(6)
    k_max = get_config(ARCH).k_max
    mha = dict(h=32, kv=k_max, rpg=1, hd=128, dtype=torch.bfloat16,
               empty_rep=7)
    gqa = dict(h=48, kv=8, rpg=5, hd=128, dtype=torch.bfloat16,
               empty_rep=None)
    cases = {"chai_fused_decode": [], "paged_chai_fused_decode": []}
    for tag, kw, b, s, pos, warm in (
            ("splits_partial_last", mha, 4, MAX_SEQ, (1023, 1000, 900, 885),
             False),
            ("first_split_only_rows", mha, 4, MAX_SEQ, (10, 0, 150, 700),
             False),
            ("warmup_row", mha, 4, MAX_SEQ, None, True),
            ("nemotron_gqa", gqa, 4, MAX_SEQ, None, False),
            ("long_65536_mha", mha, 1, 65536, (65535,), False),
            ("long_65536_gqa", gqa, 1, 65536, (65535,), False)):
        q, k, v, h2c, p = synthetic_case(gen, b=b, s=s, **kw)
        if pos is not None:
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        if warm:
            h2c[1] = 0
        recs = fused_pair_case(tag, q, k, v, h2c, p, rpg=kw["rpg"], gen=gen,
                               null_k_rows=(1,) if warm else ())
        for name, rec in recs.items():
            cases[name].append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    relay = []
    dev = "cuda"
    r, h, hd, sp, nmax = k_max, 32, 128, 65536, 4
    plen = torch.tensor([sp, 50000], dtype=torch.int32, device=dev)
    g = len(plen)
    q = torch.randn(g, nmax * r, hd, generator=gen, device=dev)
    k = torch.randn(g, h, sp, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn(g, h, sp, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    k_row = torch.stack([torch.cat([torch.randperm(
        h, generator=gen, device=dev)[:r] for _ in range(nmax)])
        for _ in range(g)]).int()
    a_row = torch.stack([torch.cat([j * r + torch.randint(
        0, r, (h,), generator=gen, device=dev) for j in range(nmax)])
        for _ in range(g)]).int()
    v_row = torch.arange(h, device=dev).repeat(g, nmax).int()
    case = dict(case="long_65536_g2_bfloat16",
                **relay_case(q, k, v, k_row, a_row, v_row, plen, PAGE,
                             per_l=True))
    relay.append(case)
    _log_relay(case)
    log(f"relay_prefix_decode {case['case']}: device {case['device_ms']} ms"
        f" = {(case['device_ms'] or float('nan')) / case['bound_ms']:.2f} x "
        "its bound")
    del q, k, v
    torch.cuda.empty_cache()
    return cases, relay


# ------------------------------------------ phase 3: the int8 modes ----
def _quantized(x):
    """int8 codes and fp32 row scales of ``x`` (the port's ``quant_rows``,
    the int8 cache's own rule), and the bf16 rows they stand for (the
    bf16 run beside, on the same shapes)."""
    codes, scale = chai_cache.quant_rows(x)
    return codes, scale, chai_cache.dequant_rows(codes, scale).to(
        torch.bfloat16)


def _beside(rec, other, prefix="bf16"):
    """The same kernel's numbers in another mode on the same shapes (bf16
    against int8; the K-only mode against share_values), into ``rec``."""
    rec.update({f"{prefix}_{k}": other.get(k) for k in (
        "ms", "device_ms", "single_call_ms", "bound_ms", "max_abs_err")})
    return rec


def int8_kernel_checks():
    """The int8 modes of the four kernels at full width (hd 128, page 16),
    on codes and scales from ``quant_rows``, each against its plain
    version at 2e-5, with its device (profiler), back-to-back and single
    times and its int8 bound (1 B a code plus 4 B a row-position scale),
    each beside the same kernel's bf16 numbers on the same shapes (the
    dequantized rows in bf16):

    * the fused pair (``fused_pair_case``: shuffled pages with the null
      page 0, paged == dense ``torch.equal`` at page = tile, two launches
      ``torch.equal``, emit + identity merge + finalize == finalized): MHA
      (chai-llama-7b's 32 heads, k_max = 25 reps, a WARMUP-like row), GQA
      (nemotron's 48 heads over 8 KV groups, reps_per_group = 5), and one
      row of S = 65,536 of each;
    * ``relay_prefix_decode``: MHA groups of 4 and 3 members (the fourth
      slot of group 1 padded), GQA groups of 4 and 3, and Sp = 65,536
      (plen 65,536 and 50,000; acc held over l as in the bf16 case);
    * ``paged_prefix_attend``: bf16 queries over an int8 pool on shuffled
      pages, rows at plen 0 (the merge identity exactly), 200 and 384, and
      nemotron's 48 heads over 8 at plen 384; two launches ``torch.equal``.
    Returns {kernel: [records]}."""
    gen = torch.Generator("cuda").manual_seed(7)
    dev = "cuda"
    k_max = get_config(ARCH).k_max
    mha = dict(h=32, kv=k_max, rpg=1, hd=128, dtype=torch.float32,
               empty_rep=7)
    gqa = dict(h=48, kv=8, rpg=5, hd=128, dtype=torch.float32,
               empty_rep=None)
    out = {"chai_fused_decode": [], "paged_chai_fused_decode": [],
           "relay_prefix_decode": [], "paged_prefix_attend": []}
    for tag, kw, b, s, warm in (
            ("int8_mha", mha, 4, MAX_SEQ, True),
            ("int8_nemotron_gqa", gqa, 4, MAX_SEQ, False),
            ("int8_long_65536_mha", mha, 1, 65536, False),
            ("int8_long_65536_gqa", gqa, 1, 65536, False)):
        q, k, v, h2c, p = synthetic_case(gen, b=b, s=s, **kw)
        if s > MAX_SEQ:                   # a long row: every position live
            p = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
        if warm:
            h2c[1] = 0
        kq, ks, kb = _quantized(k)
        vq, vs, vb = _quantized(v)
        del k, v
        null = (1,) if warm else ()
        recs = fused_pair_case(tag, q, kq, vq, h2c, p, rpg=kw["rpg"],
                               gen=gen, null_k_rows=null, k_scale=ks,
                               v_scale=vs, profile=True)
        bf = fused_pair_case(f"{tag}_bf16_beside", q, kb, vb, h2c, p,
                             rpg=kw["rpg"], gen=gen, null_k_rows=null,
                             profile=True)
        for name, rec in recs.items():
            out[name].append(_beside(rec, bf[name]))
            log(f"{name} {tag}: device {rec['device_ms']} ms (bf16 "
                f"{rec['bf16_device_ms']}), back to back {rec['ms']:.4f} ms "
                f"(bf16 {rec['bf16_ms']:.4f}), single call "
                f"{rec['single_call_ms']:.4f} ms (bf16 "
                f"{rec['bf16_single_call_ms']:.4f}), bound "
                f"{rec['bound_ms']:.4f} ms (bf16 {rec['bf16_bound_ms']:.4f})")
        del kq, vq, kb, vb, q
        torch.cuda.empty_cache()
    hd, nmax = 128, 4
    for tag, members, plen, sp, gqa_maps in (
            ("int8_g2_padded_slot", (4, 3), (200, 256), 256, False),
            ("int8_gqa_group_of_3_in_4", (4, 3), (256, 180), 256, True),
            ("int8_long_65536_g2", (4, 4), (65536, 50000), 65536, False)):
        k_row, a_row, v_row, r, kv, vr = relay_maps(gen, members, nmax,
                                                    gqa=gqa_maps)
        g = len(members)
        plen_t = torch.tensor(plen, dtype=torch.int32, device=dev)
        q = torch.randn(g, nmax * r, hd, generator=gen, device=dev)
        k = torch.randn(g, kv, sp, hd, generator=gen, device=dev)
        v = torch.randn(g, vr, sp, hd, generator=gen, device=dev)
        for i, n in enumerate(plen):      # the engine's views: zero tail
            k[i, :, n:] = 0
            v[i, :, n:] = 0
        kq, ks, kb = _quantized(k)
        vq, vs, vb = _quantized(v)
        del k, v
        long = sp > MAX_SEQ
        rec = dict(case=tag, **relay_case(q, kq, vq, k_row, a_row, v_row,
                                          plen_t, PAGE, per_l=long,
                                          k_scale=ks, v_scale=vs))
        call = lambda: ck.relay_prefix_decode(  # noqa: E731
            q, kq, vq, k_row, a_row, v_row, plen_t, ts=PAGE, k_scale=ks,
            v_scale=vs)
        rec["single_call_ms"] = single_call_ms(call, reps=5)
        bf = relay_case(q, kb, vb, k_row, a_row, v_row, plen_t, PAGE,
                        per_l=long)
        bf["single_call_ms"] = single_call_ms(
            lambda: ck.relay_prefix_decode(q, kb, vb, k_row, a_row, v_row,
                                           plen_t, ts=PAGE), reps=5)
        out["relay_prefix_decode"].append(_beside(rec, bf))
        _log_relay(rec)
        log(f"relay_prefix_decode {tag}: device {rec['device_ms']} ms (bf16 "
            f"{rec['bf16_device_ms']}), bound {rec['bound_ms']:.4f} ms (bf16 "
            f"{rec['bf16_bound_ms']:.4f})")
        del kq, vq, kb, vb
        torch.cuda.empty_cache()
    n_pool, p_slot = 2 * SLOTS * MAX_SEQ // PAGE + 1, MAX_SEQ // PAGE
    for tag, (b, h, kv, plens) in {
            "int8_rows_0_200_384": (3, 32, 32, (0, 200, 384)),
            "int8_plen0": (1, 32, 32, (0,)),
            "int8_gqa_h48_kv8_plen384": (1, 48, 8, (384,))}.items():
        pool, spool, poolb = _quantized(torch.randn(
            n_pool, kv, PAGE, hd, generator=gen, device=dev))
        ids = (torch.randperm(n_pool - 1, generator=gen, device=dev)
               + 1).to(torch.int32)
        bt_k = ids[:b * p_slot].reshape(b, p_slot)
        bt_v = ids[b * p_slot:2 * b * p_slot].reshape(b, p_slot)
        plen = torch.tensor(plens, dtype=torch.int32, device=dev)
        q = torch.randn(b, 128, h, hd, generator=gen,
                        device=dev).to(torch.bfloat16)
        args = (q, pool, bt_k, bt_v, plen)
        sc = dict(k_scale_pool=spool, v_scale_pool=spool)
        _bitwise(f"paged_prefix_attend {tag}: two launches",
                 fk.paged_prefix_attend(*args, **sc),
                 fk.paged_prefix_attend(*args, **sc))
        rec = dict(case=tag, **prefix_case(*args, **sc), repeat_bitwise=True)
        bf = prefix_case(q, poolb, bt_k, bt_v, plen)
        for r_, a_, kw_ in ((rec, args, sc), (bf, (q, poolb, bt_k, bt_v,
                                                  plen), {})):
            call = lambda a_=a_, kw_=kw_: fk.paged_prefix_attend(  # noqa
                *a_, **kw_)
            r_["device_ms"] = device_ms(call, "paged_prefix_attend_kernel")
            r_["single_call_ms"] = single_call_ms(call)
        out["paged_prefix_attend"].append(_beside(rec, bf))
        _log_case("paged_prefix_attend", rec)
        log(f"paged_prefix_attend {tag}: device {rec['device_ms']} ms (bf16 "
            f"{rec['bf16_device_ms']}), bound {rec['bound_ms']:.4f} ms (bf16 "
            f"{rec['bf16_bound_ms']:.4f}), two launches bitwise")
        del pool, spool, poolb
        torch.cuda.empty_cache()
    return out


# ------------------------------------------ phase 3: the K/V pairings ----
# Each side of a K/V pairing: fp32, bf16 or raw int8 codes, each with
# ("s") or without its fp32 row scales; the names of ``ck.kv_modes``.
KV_SIDES = ("f32", "bf16", "i8", "f32s", "bf16s", "i8s")
# The pairings the serving paths run, held by the checks above; every
# other pairing counts its launches by mode as "<kernel>[kv=<K>/<V>]", but
# int8 K with scales beside raw int8 V on the fused pair, which runs its
# int8 body (``ck.kv_body``) and counts as "<kernel>[int8]".
KV_PATHS = (("f32", "f32"), ("bf16", "bf16"), ("i8s", "i8s"))
KV_PAIRS = tuple((a, b) for a in KV_SIDES for b in KV_SIDES
                 if (a, b) not in KV_PATHS)
# Pairings also run in the share and the softcap mode of the fused pair.
KV_SHARE = (("bf16", "i8"), ("i8s", "bf16"), ("i8", "i8"), ("f32s", "f32"),
            ("bf16", "bf16s"), ("f32", "i8s"))
KV_SOFTCAP = (("i8s", "bf16"), ("bf16", "i8"), ("f32", "bf16s"))


def kv_side(x, kind, gen):
    """One side of a K/V pairing made from the fp32 rows ``x``: fp32 or
    bf16 rows; raw int8 codes, ``plain_int8(x * CODE_SCALE)`` (read as
    values); with "s", fp32 row scales beside them (``quant_rows`` codes
    for int8; scales in [0.5, 1.5) for float rows). Returns (rows, scales
    or None)."""
    base, scaled = kind.rstrip("s"), kind.endswith("s")
    if base == "i8":
        if scaled:
            return chai_cache.quant_rows(x)
        return chai_cache.plain_int8(x * CODE_SCALE), None
    rows = x.to(torch.float32 if base == "f32" else torch.bfloat16)
    if not scaled:
        return rows, None
    return rows, torch.rand(x.shape[:-1], generator=gen,
                            device=x.device) + 0.5


def _kv_query(q, k_kind):
    """The queries beside raw int8 K codes (x CODE_SCALE) scaled down by
    CODE_SCALE, so that the scores keep a float K's range."""
    return q / CODE_SCALE if k_kind == "i8" else q


def _kv_unit(v_kind):
    """Raw int8 V codes: outputs held over the codes' range."""
    return CODE_RANGE if v_kind == "i8" else 1.0


def kv_pairing_checks():
    """Every K/V pairing the Pallas wrappers take beside the three the
    serving paths run (``KV_PAIRS``: K and V each fp32, bf16 or int8,
    each with or without its row scales; raw int8 K beside queries over
    ``CODE_SCALE``, raw int8 V held over ``CODE_RANGE``), each against its
    plain version at 2e-5 at full width (hd 128, page 16):

    * the fused pair (``fused_pair_case``: shuffled pages with the null
      page 0, paged == dense ``torch.equal`` at page = tile, two launches
      ``torch.equal``, emit + identity merge + finalize == finalized): MHA
      (chai-llama-7b's 32 heads over k_max = 25 reps, a WARMUP-like row;
      profiled) and GQA (nemotron's 48 heads over 8 KV groups, 5 reps a
      group); ``KV_SHARE`` in the share mode and ``KV_SOFTCAP`` under a
      cap of 30; int8 K with scales beside bf16 V at S = 65,536 (B 1);
    * ``relay_prefix_decode`` (but on int8 K with scales beside raw int8
      V, the share relay's own pairing): MHA groups of 4 and 3 members
      (the fourth slot of group 1 padded) at plen 200 and 256 over Sp =
      256, launched twice ``torch.equal``; raw int8 V held over l and
      over 127;
    * ``paged_prefix_attend``: each pool (fp32, bf16 beside queries of its
      type; int8 beside bf16 queries) with each of its scale pools or
      none, rows at plen 0, 200 and 384 on shuffled pages; two launches
      ``torch.equal``.
    Returns {row name: [records]}, the row of each pairing's body:
    "<kernel>[kv=<K>/<V>]" on the general body, "<kernel>[int8]" for the
    fused pair's int8 K with scales beside raw int8 V (the int8 body)."""
    gen = torch.Generator("cuda").manual_seed(11)
    dev = "cuda"
    k_max = get_config(ARCH).k_max
    mha = dict(h=32, kv=k_max, rpg=1, hd=128, dtype=torch.float32,
               empty_rep=7)
    gqa = dict(h=48, kv=8, rpg=5, hd=128, dtype=torch.float32,
               empty_rep=None)
    out = {}

    def add(kernel, pair, rec, mode=None):
        mode = mode or f"kv={pair[0]}/{pair[1]}"
        out.setdefault(f"{kernel}[{mode}]", []).append(rec)

    def fused(pair, tag, kw, b, s, *, warm=False, profile=False, **mode):
        q, k, v, h2c, p = synthetic_case(gen, b=b, s=s, **kw)
        if s > MAX_SEQ:                   # a long row: every position live
            p = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
        if warm:
            h2c[1] = 0
        if mode.get("share"):             # V clustered like K: R rows
            v = torch.randn(b, k.shape[1], s, kw["hd"], generator=gen,
                            device=dev)
        kk, ks = kv_side(k, pair[0], gen)
        vv, vs = kv_side(v, pair[1], gen)
        del k, v
        recs = fused_pair_case(
            f"kv_{pair[0]}_{pair[1]}_{tag}", _kv_query(q, pair[0]), kk, vv,
            h2c, p, rpg=kw["rpg"], gen=gen, null_k_rows=(1,) if warm else (),
            k_scale=ks, v_scale=vs, profile=profile,
            v_unit=_kv_unit(pair[1]), **mode)
        body = ck.kv_body(kk, ks, vv, vs)
        for name, rec in recs.items():
            rec["pairing"] = "/".join(pair)
            add(name, pair, rec,
                "int8" if body == ck.KV_INT8 else None)
        torch.cuda.empty_cache()

    for pair in KV_PAIRS:
        fused(pair, "mha", mha, 4, MAX_SEQ, warm=True, profile=True)
        fused(pair, "nemotron_gqa", gqa, 4, MAX_SEQ)
    for pair in KV_SHARE:
        fused(pair, "share", mha, 4, MAX_SEQ, warm=True, share=True)
    for pair in KV_SOFTCAP:
        fused(pair, "softcap30", mha, 4, MAX_SEQ, softcap=30.0)
    fused(("i8s", "bf16"), "long_65536_mha", mha, 1, 65536, profile=True)

    hd, nmax, sp = 128, 4, 256
    k_row, a_row, v_row, r, kv, vr = relay_maps(gen, (4, 3), nmax,
                                                gqa=False)
    plen = (200, 256)
    plen_t = torch.tensor(plen, dtype=torch.int32, device=dev)
    # int8 K with scales beside raw int8 V is the share relay's own
    for pair in (p for p in KV_PAIRS if p != ("i8s", "i8")):
        q = torch.randn(2, nmax * r, hd, generator=gen, device=dev)
        k = torch.randn(2, kv, sp, hd, generator=gen, device=dev)
        v = torch.randn(2, vr, sp, hd, generator=gen, device=dev)
        for i, n in enumerate(plen):      # the engine's views: zero tail
            k[i, :, n:] = 0
            v[i, :, n:] = 0
        kk, ks = kv_side(k, pair[0], gen)
        vv, vs = kv_side(v, pair[1], gen)
        qq, unit = _kv_query(q, pair[0]), _kv_unit(pair[1])
        rec = dict(case=f"kv_{pair[0]}_{pair[1]}_g2_padded_slot",
                   pairing="/".join(pair),
                   **relay_case(qq, kk, vv, k_row, a_row, v_row, plen_t,
                                PAGE, per_l=unit != 1, v_unit=unit,
                                k_scale=ks, v_scale=vs))
        rec["single_call_ms"] = single_call_ms(
            lambda: ck.relay_prefix_decode(qq, kk, vv, k_row, a_row, v_row,
                                           plen_t, ts=PAGE, k_scale=ks,
                                           v_scale=vs), reps=5)
        add("relay_prefix_decode", pair, rec)
        _log_relay(rec)

    b, h, pkv, p_slot = 3, 32, 32, MAX_SEQ // PAGE
    n_pool = 2 * b * p_slot + 1
    ids = (torch.randperm(n_pool - 1, generator=gen, device=dev)
           + 1).to(torch.int32)
    bt_k = ids[:b * p_slot].reshape(b, p_slot)
    bt_v = ids[b * p_slot:2 * b * p_slot].reshape(b, p_slot)
    plen_p = torch.tensor((0, 200, 384), dtype=torch.int32, device=dev)
    for base in ("f32", "bf16", "i8"):
        x = torch.randn(n_pool, pkv, PAGE, hd, generator=gen, device=dev)
        q = torch.randn(b, 128, h, hd, generator=gen, device=dev)
        for k_s, v_s in ((False, False), (True, False), (False, True),
                         (True, True)):
            pair = (base + "s" * k_s, base + "s" * v_s)
            if pair in KV_PATHS:
                continue
            pool, spool = kv_side(x, base + ("s" if k_s or v_s else ""),
                                  gen)
            sc = dict(k_scale_pool=spool if k_s else None,
                      v_scale_pool=spool if v_s else None)
            qq = _kv_query(q, pair[0]).to(
                torch.float32 if base == "f32" else torch.bfloat16)
            args = (qq, pool, bt_k, bt_v, plen_p)
            _bitwise(f"paged_prefix_attend kv {pair}: two launches",
                     fk.paged_prefix_attend(*args, **sc),
                     fk.paged_prefix_attend(*args, **sc))
            rec = dict(case=f"kv_{pair[0]}_{pair[1]}_rows_0_200_384",
                       pairing="/".join(pair),
                       **prefix_case(*args, v_unit=_kv_unit(pair[1]), **sc),
                       repeat_bitwise=True)
            call = lambda a_=args, kw_=sc: fk.paged_prefix_attend(  # noqa
                *a_, **kw_)
            rec["device_ms"] = device_ms(call, "paged_prefix_attend_kernel")
            rec["single_call_ms"] = single_call_ms(call)
            add("paged_prefix_attend", pair, rec)
            _log_case("paged_prefix_attend", rec)
        torch.cuda.empty_cache()
    return out


# ------------------------------------- phase 3: the share_values modes ----
def share_relay_maps(gen, members, nmax, r, h):
    """The engine's share_values relay maps (``serving.engine.
    _relay_row_maps``): member j of a group owns query rows and acc rows
    [j*R, (j+1)*R); query row j*R + i reads the dense K row reps[i], acc
    row j*R + i reads query row j*R + i and the dense V row reps[i].
    Padded entries stay 0. Returns (k_row, a_row, v_row)."""
    dev = "cuda"
    g = len(members)
    k_row = torch.zeros(g, nmax * r, dtype=torch.int32, device=dev)
    a_row = torch.zeros(g, nmax * r, dtype=torch.int32, device=dev)
    v_row = torch.zeros(g, nmax * r, dtype=torch.int32, device=dev)
    for i, n_mem in enumerate(members):
        for j in range(n_mem):
            reps = torch.randperm(h, generator=gen, device=dev)[:r]
            k_row[i, j * r:(j + 1) * r] = reps
            v_row[i, j * r:(j + 1) * r] = reps
            a_row[i, j * r:(j + 1) * r] = torch.arange(
                j * r, (j + 1) * r, device=dev)
    return k_row, a_row, v_row


def share_kernel_checks():
    """The share_values mode of the three kernels at full width (hd 128,
    page 16; chai-llama-7b's 32 heads and k_max = 25 reps), each against
    its plain version at 2e-5, beside the K-only mode on the same shapes
    (device, back-to-back and single times, bound):

    * the fused pair (``fused_pair_case(share=True)``: shuffled pages
      with the null page 0, paged == dense ``torch.equal`` at page =
      tile, two launches ``torch.equal``, emit + identity merge +
      finalize == finalized): bf16 with several splits and a partial last
      one and a rep without members; a WARMUP-like row (every head in rep
      0, all-null K and V tables); one row of S = 65,536; int8 (K codes
      with scales, V raw codes in the full code range and no scales: the
      reference's clustered V) with a WARMUP-like row, and at S = 65,536.
      The K-only mode beside reads per-head V (B, 32, S, hd) (int8: with
      scales);
    * ``relay_prefix_decode`` on the share shape (``share_relay_maps``:
      A = Nmax R acc rows, V rows the reps' dense rows): groups of 4 and 3
      members (the fourth slot of group 1 padded) at plen 200 and 256, bf16
      and int8 (K scaled, V codes scale-less; acc held over l), and Sp =
      65,536 (plen 65,536 and 50,000; acc held over l), beside the K-only
      maps
      (``relay_maps``: A = Nmax H) on the same K and V.
    Returns {kernel: [records]}."""
    gen = torch.Generator("cuda").manual_seed(8)
    dev = "cuda"
    k_max, h, hd = get_config(ARCH).k_max, 32, 128
    out = {"chai_fused_decode": [], "paged_chai_fused_decode": [],
           "relay_prefix_decode": []}
    for tag, b, s, int8, warm, pos in (
            ("share_bf16_splits", 4, MAX_SEQ, False, False,
             (1023, 1000, 900, 885)),
            ("share_bf16_warmup_row", 4, MAX_SEQ, False, True, None),
            ("share_bf16_long_65536", 1, 65536, False, False, (65535,)),
            ("share_int8_warmup_row", 4, MAX_SEQ, True, True, None),
            ("share_int8_long_65536", 1, 65536, True, False, (65535,))):
        q, k, v_h, h2c, p = synthetic_case(
            gen, b=b, h=h, kv=k_max, rpg=1, s=s, hd=hd,
            dtype=torch.float32 if int8 else torch.bfloat16, empty_rep=7)
        if pos is not None:
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
        if warm:
            h2c[1] = 0
        null = (1,) if warm else ()
        if int8:
            kq, ks, _ = _quantized(k)
            vq, vs, _ = _quantized(v_h)
            v_share = torch.randint(-127, 128, (b, k_max, s, hd),
                                    generator=gen, device=dev,
                                    dtype=torch.int8)
            recs = fused_pair_case(tag, q, kq, v_share, h2c, p, rpg=1,
                                   gen=gen, null_k_rows=null, k_scale=ks,
                                   profile=True, share=True)
            konly = fused_pair_case(f"{tag}_konly_beside", q, kq, vq, h2c, p,
                                    rpg=1, gen=gen, null_k_rows=null,
                                    k_scale=ks, v_scale=vs, profile=True)
            del kq, vq, v_share
        else:
            v_share = torch.randn(b, k_max, s, hd, generator=gen,
                                  device=dev).to(torch.bfloat16)
            recs = fused_pair_case(tag, q, k, v_share, h2c, p, rpg=1,
                                   gen=gen, null_k_rows=null, profile=True,
                                   share=True)
            konly = fused_pair_case(f"{tag}_konly_beside", q, k, v_h, h2c, p,
                                    rpg=1, gen=gen, null_k_rows=null,
                                    profile=True)
            del v_share
        for name, rec in recs.items():
            out[name].append(_beside(rec, konly[name], "konly"))
            log(f"{name} {tag} [share]: device {rec['device_ms']} ms "
                f"(K-only {rec['konly_device_ms']}), back to back "
                f"{rec['ms']:.4f} ms (K-only {rec['konly_ms']:.4f}), single "
                f"call {rec['single_call_ms']:.4f} ms (K-only "
                f"{rec['konly_single_call_ms']:.4f}), bound "
                f"{rec['bound_ms']:.4f} ms (K-only "
                f"{rec['konly_bound_ms']:.4f})")
        del q, k, v_h
        torch.cuda.empty_cache()
    nmax = 4
    for tag, members, plen, sp, int8 in (
            ("share_relay_g2_bfloat16", (4, 3), (200, 256), 256, False),
            ("share_relay_g2_int8", (4, 3), (200, 256), 256, True),
            ("share_relay_long_65536_g2_bfloat16", (4, 4), (65536, 50000),
             65536, False)):
        k_row, a_row, v_row = share_relay_maps(gen, members, nmax, k_max, h)
        kk_row, ka_row, kv_row, *_ = relay_maps(gen, members, nmax,
                                                gqa=False)
        g = len(members)
        plen_t = torch.tensor(plen, dtype=torch.int32, device=dev)
        q = torch.randn(g, nmax * k_max, hd, generator=gen, device=dev)
        k = torch.randn(g, h, sp, hd, generator=gen, device=dev)
        v = torch.randn(g, h, sp, hd, generator=gen, device=dev)
        for i, n in enumerate(plen):      # the engine's views: zero tail
            k[i, :, n:] = 0
            v[i, :, n:] = 0
        if int8:
            k, ks, _ = _quantized(k)
            v, vs, _ = _quantized(v)      # the dense pool's codes and scales
            sc, konly_sc = dict(k_scale=ks), dict(k_scale=ks, v_scale=vs)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            sc = konly_sc = {}
        # Raw int8 codes (up to 127) make acc a sum of terms of up to 127:
        # two summation orders round it apart by ~1e-4, so each acc row is
        # held over its l there too (the raw error is recorded).
        per_l = sp > MAX_SEQ or int8
        recs = []
        for maps, kw in (((k_row, a_row, v_row), sc),
                         ((kk_row, ka_row, kv_row), konly_sc)):
            rec = relay_case(q, k, v, *maps, plen_t, PAGE, per_l=per_l,
                             **kw)
            rec["single_call_ms"] = single_call_ms(
                lambda maps=maps, kw=kw: ck.relay_prefix_decode(
                    q, k, v, *maps, plen_t, ts=PAGE, **kw), reps=5)
            recs.append(rec)
        rec = dict(case=tag, share_values=True, **recs[0])
        out["relay_prefix_decode"].append(_beside(rec, recs[1], "konly"))
        _log_relay(rec)
        log(f"relay_prefix_decode {tag} [share]: device {rec['device_ms']} "
            f"ms (K-only maps {rec['konly_device_ms']}), single call "
            f"{rec['single_call_ms']:.4f} ms (K-only "
            f"{rec['konly_single_call_ms']:.4f}), bound "
            f"{rec['bound_ms']:.4f} ms (K-only {rec['konly_bound_ms']:.4f})")
        del q, k, v
        torch.cuda.empty_cache()
    return out


# ------------------------------------------ phase 3: the softcap mode ----
GEMMA = "gemma2-9b"            # local + global layers, softcaps, hd 224
DANUBE = "h2o-danube-1.8b"     # all local, window 4096, hd 80


def softcap_kernel_checks():
    """The softcap mode of the fused pair in every other mode, at hd 128
    (chai-llama-7b's MHA shape, 32 heads over k_max = 25 reps, and
    nemotron's GQA, 48 over 8 groups of 5 reps) and at hd 224 (gemma2's:
    MHA over 16 heads and 12 reps, and its GQA, 16 heads over 8 groups of
    2 reps): bf16 with several splits (gemma2's cap 50), a WARMUP-like
    row, fp32 at a live cap of 5, int8 K/V with scales, share_values
    bf16 and int8 (raw V codes), GQA bf16 and int8, and at hd 224 one row
    of S = 65,536. Each through ``fused_pair_case(softcap=...)``: both
    kernels at 2e-5 against the plain version, the state too, paged ==
    dense, two launches and emit + identity merge + finalize
    ``torch.equal``, capped unequal to uncapped; the two bf16 main shapes
    also uncapped beside (device, back-to-back and single times, bound).
    Returns {kernel: [records]}."""
    gen = torch.Generator("cuda").manual_seed(12)
    dev = "cuda"
    out = {"chai_fused_decode": [], "paged_chai_fused_decode": []}
    shapes = {128: dict(mha=dict(h=32, kv=get_config(ARCH).k_max, rpg=1),
                        gqa=dict(h=48, kv=8, rpg=5)),
              224: dict(mha=dict(h=16, kv=12, rpg=1),
                        gqa=dict(h=16, kv=8, rpg=2))}
    grid = []
    for hd in (128, 224):
        grid += [
            (hd, "mha", "bf16_splits", 4, MAX_SEQ, torch.bfloat16, 50.0,
             dict(beside=True, pos=(1023, 1000, 900, 885))),
            (hd, "mha", "bf16_warmup_row", 4, MAX_SEQ, torch.bfloat16, 50.0,
             dict(warm=True)),
            (hd, "mha", "fp32_cap5", 4, MAX_SEQ, torch.float32, 5.0, {}),
            (hd, "mha", "int8", 4, MAX_SEQ, "int8", 5.0, {}),
            (hd, "mha", "share_bf16", 4, MAX_SEQ, torch.bfloat16, 50.0,
             dict(share=True, warm=True)),
            (hd, "mha", "share_int8", 4, MAX_SEQ, "int8", 5.0,
             dict(share=True)),
            (hd, "gqa", "bf16", 4, MAX_SEQ, torch.bfloat16, 50.0,
             dict(beside=hd == 224)),
            (hd, "gqa", "int8", 4, MAX_SEQ, "int8", 5.0, {})]
    grid.append((224, "gqa", "bf16_long_65536", 1, 65536, torch.bfloat16,
                 50.0, dict(pos=(65535,))))
    for hd, kind, name, b, s, dtype, cap, opt in grid:
        tag = f"softcap_hd{hd}_{kind}_{name}"
        kw = shapes[hd][kind]
        int8 = dtype == "int8"
        q, k, v, h2c, p = synthetic_case(
            gen, b=b, s=s, hd=hd, empty_rep=7 if kw["rpg"] == 1 else None,
            dtype=torch.float32 if int8 else dtype, **kw)
        if "pos" in opt:
            p = torch.tensor(opt["pos"], dtype=torch.int32, device=dev)
        if opt.get("warm"):
            h2c[1] = 0
        # scores of a few units: a live cap of 5 bends them hard, gemma2's
        # 50 a little; the inputs are scaled up so 50 is live too
        q = q * 4
        scales = {}
        if opt.get("share"):
            v = (torch.randint(-127, 128, (b, kw["kv"], s, hd), generator=gen,
                               device=dev, dtype=torch.int8) if int8
                 else torch.randn(b, kw["kv"], s, hd, generator=gen,
                                  device=dev).to(dtype))
        if int8:
            k, ks, _ = _quantized(k)
            scales["k_scale"] = ks
            if not opt.get("share"):
                v, vs, _ = _quantized(v)
                scales["v_scale"] = vs
        recs = fused_pair_case(
            tag, q, k, v, h2c, p, rpg=kw["rpg"], gen=gen,
            null_k_rows=(1,) if opt.get("warm") else (), profile=True,
            share=bool(opt.get("share")), softcap=cap, **scales)
        if opt.get("beside"):
            plain = fused_pair_case(f"{tag}_uncapped_beside", q, k, v, h2c,
                                    p, rpg=kw["rpg"], gen=gen, profile=True,
                                    **scales)
            for name_k in recs:
                _beside(recs[name_k], plain[name_k], "uncapped")
        for name_k, rec in recs.items():
            out[name_k].append(rec)
            log(f"{name_k} {tag} [softcap {cap}]: device {rec['device_ms']}"
                f" ms (uncapped {rec.get('uncapped_device_ms')}), back to "
                f"back {rec['ms']:.4f} ms, single call "
                f"{rec['single_call_ms']:.4f} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), max_abs_err "
                f"{rec['max_abs_err']:.3e}")
        del q, k, v
        torch.cuda.empty_cache()
    return out


# ------------------------- phase 3: the prefill and relay kernels' modes ----
GEMMA_CAP = 50.0               # gemma2-9b's attention-logit softcap
# The mode checks' scores: queries scaled by 4 (scores of a few units,
# bent by gemma2's cap of 50), in every dtype.
MODE_Q = 4.0
GEMMA_HEADS = (16, 8, 224)     # gemma2-9b's query heads, KV heads, head dim


def _state_identity_rows(name, state, rows):
    """Rows ``rows`` (a bool mask over the query axis) of a head-major
    state must be the exact merge identity (m = -2e38, l = 0, acc = 0)."""
    m, l, acc = (x[:, :, rows] for x in state)
    if not ((m == kref.NEG_INF).all() and (l == 0).all()
            and (acc == 0).all()):
        raise AssertionError(f"{name}: a row that sees no key is not the "
                             "merge identity")


def prefill_mode_checks():
    """The softcap and window modes of ``flash_prefill`` and the softcap of
    ``paged_prefix_attend`` and ``relay_prefix_decode``, each at 2e-5
    against its plain version (a finalized bf16 output at one bf16 step),
    at hd 128 (32 heads) and hd 224 (gemma2's 16 heads over 8), bf16 and
    fp32: ``flash_prefill`` T = 128 at offset 384 over S = 512, capped at
    gemma2's 50, in a window of 128 (the first four 64-key tiles lie
    outside every row's window) and both, finalized and as state; rows
    past S + window - 1 (T = 64 at offset 150 over S = 160, window 32)
    the exact merge identity (finalized: zeros); ``paged_prefix_attend``
    at plen 0/200/384 (hd 128) and 256 (hd 224), bf16, fp32 and int8;
    the relay kernel on MHA, GQA and share_values maps, bf16 and int8.
    Bitwise: every case launched twice ``torch.equal``; capped unequal to
    uncapped; softcap 0 and a window wider than every row's reach equal
    the plain launch. The window's main case is timed beside SDPA with the
    band mask. Returns {row name: [records]}."""
    gen = torch.Generator("cuda").manual_seed(23)
    dev = "cuda"
    out = {"flash_prefill[softcap]": [], "flash_prefill[window]": [],
           "paged_prefix_attend[softcap]": [],
           "paged_prefix_attend[int8+softcap]": [],
           "relay_prefix_decode[softcap]": []}

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    heads = {128: (32, 32), 224: GEMMA_HEADS[:2]}
    for hd in (128, 224):
        h, kv = heads[hd]
        for dtype in (torch.bfloat16, torch.float32):
            # queries scaled up so that a cap of 50 bends the scores
            qs, cap = MODE_Q, GEMMA_CAP
            q = rand(1, 128, h, hd, dtype=dtype, scale=qs)
            k, v = (rand(1, 512, kv, hd, dtype=dtype) for _ in range(2))
            for mode, kw in (("softcap", dict(softcap=cap)),
                             ("window", dict(window=128)),
                             ("window_softcap", dict(window=128,
                                                     softcap=cap))):
                for emit in (True, False):
                    main = (hd == 128 and dtype == torch.bfloat16 and emit
                            and mode == "window")
                    rec = dict(case=f"hd{hd}_{str(dtype)[6:]}_{mode}_"
                                    f"offset384_{'state' if emit else 'fin'}",
                               **flash_case(q, k, v, offset=384,
                                            emit_state=emit, library=main,
                                            **kw))
                    call = lambda kw=kw, emit=emit: fk.flash_prefill(  # noqa
                        q, k, v, offset=384, emit_state=emit, **kw)
                    _bitwise(f"flash_prefill {rec['case']}: two launches",
                             call(), call())
                    plain = fk.flash_prefill(q, k, v, offset=384,
                                             emit_state=emit)
                    if _max_err(call(), plain) < 1e-3:
                        raise AssertionError(f"flash_prefill {rec['case']}: "
                                             "the mode changes nothing")
                    rec["repeat_bitwise"] = True
                    if emit and dtype == torch.bfloat16:
                        # the mode's device time beside the plain mode's
                        rec["device_ms"] = device_ms(call,
                                                     "flash_prefill_kernel")
                        rec["plain_mode_device_ms"] = device_ms(
                            lambda: fk.flash_prefill(q, k, v, offset=384,
                                                     emit_state=True),
                            "flash_prefill_kernel")
                    if main:
                        out["flash_prefill[window]"].insert(0, rec)
                    else:
                        out["flash_prefill[" + mode.split("_")[0]
                            + "]"].append(rec)
                    _log_case("flash_prefill", rec)
            for emit in (True, False):
                plain = fk.flash_prefill(q, k, v, offset=384,
                                         emit_state=emit)
                _bitwise("flash_prefill: softcap 0 and a window past every "
                         "row's reach against the plain launch", plain,
                         fk.flash_prefill(q, k, v, offset=384, softcap=0.0,
                                          window=4096, emit_state=emit))
            # rows 191 .. 213 see no key inside their window of 32
            q2 = rand(2, 64, h, hd, dtype=dtype, scale=qs)
            k2, v2 = (rand(2, 160, kv, hd, dtype=dtype) for _ in range(2))
            empty = torch.arange(150, 214, device=dev) >= 191
            for kw in (dict(window=32), dict(window=32, softcap=cap)):
                for emit in (True, False):
                    rec = dict(case=f"hd{hd}_{str(dtype)[6:]}_empty_rows_"
                                    f"{'softcap_' if 'softcap' in kw else ''}"
                                    f"{'state' if emit else 'fin'}",
                               **flash_case(q2, k2, v2, offset=150,
                                            emit_state=emit, **kw))
                    got = fk.flash_prefill(q2, k2, v2, offset=150,
                                           emit_state=emit, **kw)
                    if emit:
                        _state_identity_rows("flash_prefill", got, empty)
                        _state_identity_rows(
                            "flash_prefill_state_ref",
                            kref.flash_prefill_state_ref(
                                q2, k2, v2, offset=150, **kw), empty)
                    elif got[:, empty].any():
                        raise AssertionError("flash_prefill: a row that "
                                             "sees no key is not zeros")
                    rec["identity_rows"] = int(empty.sum())
                    out["flash_prefill[window]"].append(rec)
                    _log_case("flash_prefill", rec)
            del q, k, v, q2, k2, v2
    # paged_prefix_attend: bf16 and fp32 pools, and int8 with scale pools
    n_pool, p_slot = 2 * SLOTS * MAX_SEQ // PAGE + 1, MAX_SEQ // PAGE
    for hd, b, plens in ((128, 3, (0, 200, 384)), (224, 1, (256,))):
        h, kv = heads[hd]
        for kind in ("bf16", "fp32", "int8"):
            base = torch.randn(n_pool, kv, PAGE, hd, generator=gen,
                               device=dev)
            sc = {}
            if kind == "int8":
                pool, spool, _ = _quantized(base)
                sc = dict(k_scale_pool=spool, v_scale_pool=spool)
            else:
                pool = base.to(torch.bfloat16 if kind == "bf16"
                               else torch.float32)
            ids = (torch.randperm(n_pool - 1, generator=gen, device=dev)
                   + 1).to(torch.int32)
            bt_k = ids[:b * p_slot].reshape(b, p_slot)
            bt_v = ids[b * p_slot:2 * b * p_slot].reshape(b, p_slot)
            plen = torch.tensor(plens, dtype=torch.int32, device=dev)
            qdt = torch.float32 if kind == "fp32" else torch.bfloat16
            qs, cap = MODE_Q, GEMMA_CAP
            q = rand(b, 128, h, hd, scale=qs, dtype=qdt)
            args = (q, pool, bt_k, bt_v, plen)
            rec = dict(case=f"hd{hd}_{kind}_plen{'_'.join(map(str, plens))}"
                            f"_cap{cap:g}",
                       **prefix_case(*args, softcap=cap, **sc))
            call = lambda a=args, s_=sc, c_=cap: (  # noqa: E731
                fk.paged_prefix_attend(*a, softcap=c_, **s_))
            _bitwise(f"paged_prefix_attend {rec['case']}: two launches",
                     call(), call())
            uncapped = fk.paged_prefix_attend(*args, **sc)
            _bitwise(f"paged_prefix_attend {rec['case']}: softcap 0",
                     uncapped, fk.paged_prefix_attend(*args, softcap=0.0,
                                                      **sc))
            if _max_err(call(), uncapped) < 1e-3:
                raise AssertionError(f"paged_prefix_attend {rec['case']}: "
                                     "the cap changes nothing")
            rec.update(repeat_bitwise=True, device_ms=device_ms(
                call, "paged_prefix_attend_kernel"),
                single_call_ms=single_call_ms(call),
                plain_mode_device_ms=device_ms(
                    lambda a=args, s_=sc: fk.paged_prefix_attend(*a, **s_),
                    "paged_prefix_attend_kernel"))
            out["paged_prefix_attend[int8+softcap]" if kind == "int8"
                else "paged_prefix_attend[softcap]"].append(rec)
            _log_case("paged_prefix_attend", rec)
            del pool, base
            torch.cuda.empty_cache()
    # relay_prefix_decode: llama's MHA maps, nemotron's GQA maps, the
    # share_values maps (int8 V codes without scales), bf16 and int8
    hd, nmax = 128, 4
    for tag, maps, members, plen, kind in (
            ("mha_g2_bf16", "mha", (4, 3), (200, 256), "bf16"),
            ("mha_g2_int8", "mha", (4, 3), (200, 256), "int8"),
            ("gqa_g2_bf16", "gqa", (4, 3), (256, 180), "bf16"),
            ("gqa_g2_int8", "gqa", (4, 3), (256, 180), "int8"),
            ("share_g2_bf16", "share", (4, 3), (200, 256), "bf16"),
            ("share_g2_int8", "share", (4, 3), (200, 256), "int8")):
        if maps == "share":
            r, h = get_config(ARCH).k_max, 32
            k_row, a_row, v_row = share_relay_maps(gen, members, nmax, r, h)
            kv = vr = h
        else:
            k_row, a_row, v_row, r, kv, vr = relay_maps(
                gen, members, nmax, gqa=maps == "gqa")
        g, sp = len(members), 256
        plen_t = torch.tensor(plen, dtype=torch.int32, device=dev)
        # raw int8 V codes (share_values, up to 127): held over l and over
        # 127 (``relay_case``'s ``v_unit``): at these scores an fp32 score's
        # last bits move acc / l by ~127 x 1e-6, past 2e-5 of one code for
        # any two summation orders (PERF.md, open questions)
        raw_v = maps == "share" and kind == "int8"
        qs, cap = MODE_Q, GEMMA_CAP
        q = torch.randn(g, nmax * r, hd, generator=gen, device=dev) * qs
        k = torch.randn(g, kv, sp, hd, generator=gen, device=dev)
        v = torch.randn(g, vr, sp, hd, generator=gen, device=dev)
        for i, n in enumerate(plen):      # the engine's views: zero tail
            k[i, :, n:] = 0
            v[i, :, n:] = 0
        sc = {}
        if kind == "int8":
            k, sc["k_scale"], _ = _quantized(k)
            if maps == "share":
                v = torch.randint(-127, 128, v.shape, generator=gen,
                                  device=dev, dtype=torch.int8)
            else:
                v, sc["v_scale"], _ = _quantized(v)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        args = (q, k, v, k_row, a_row, v_row, plen_t)
        rec = dict(case=f"relay_{tag}_cap{cap:g}",
                   **relay_case(*args, PAGE, per_l=raw_v,
                                v_unit=127.0 if raw_v else 1.0,
                                softcap=cap, **sc))
        call = lambda a=args, s_=sc, c_=cap: (  # noqa: E731
            ck.relay_prefix_decode(*a, ts=PAGE, softcap=c_, **s_))
        uncapped = ck.relay_prefix_decode(*args, ts=PAGE, **sc)
        _bitwise(f"relay_prefix_decode {tag}: softcap 0", uncapped,
                 ck.relay_prefix_decode(*args, ts=PAGE, softcap=0.0, **sc))
        if _max_err(call()[0], uncapped[0]) < 1e-3:
            raise AssertionError(f"relay_prefix_decode {tag}: the cap "
                                 "changes nothing")
        rec["single_call_ms"] = single_call_ms(call)
        rec["plain_mode_device_ms"] = device_ms(
            lambda a=args, s_=sc: ck.relay_prefix_decode(*a, ts=PAGE, **s_),
            "relay_prefix_decode_kernel")
        out["relay_prefix_decode[softcap]"].append(rec)
        _log_relay(rec)
        del q, k, v
    return out


def gemma2_suffix_prefill_check():
    """gemma2-9b's suffix prefill in one global layer at full width (16
    heads over 8 of hd 224, cap 50, bf16): a 256-token prefix in shuffled
    pages and a 128-token suffix; ``paged_prefix_attend`` over the pages
    and ``flash_prefill`` (``emit_state``) over the suffix, merged and
    finalized, held at 2e-5 against the eager ``attention_fullseq`` with
    the softcap over all 384 positions (in fp32 on the same bf16
    values). Then the same with the prefix pages in int8 (codes and
    scales; the eager attention over the dequantized prefix). Returns
    {"flash_prefill": case, "paged_prefix_attend": case,
    "paged_prefix_attend_int8": case}."""
    from repro_torch.models import attention as attn_mod
    gen = torch.Generator("cuda").manual_seed(29)
    dev = "cuda"
    h, kv, hd = GEMMA_HEADS
    plen, t = 256, 128
    n_pages = plen // PAGE
    q = (torch.randn(1, t, h, hd, generator=gen, device=dev) * 4).to(
        torch.bfloat16)
    k, v = (torch.randn(1, plen + t, kv, hd, generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    n_pool = 2 * n_pages + 5
    ids = (torch.randperm(n_pool - 1, generator=gen, device=dev) + 1).to(
        torch.int32)
    bt_k, bt_v = ids[:n_pages][None], ids[n_pages:2 * n_pages][None]
    plen_t = torch.tensor([plen], dtype=torch.int32, device=dev)
    positions = torch.arange(plen + t, device=dev)
    cases = {}
    for kind in ("bf16", "int8"):
        sc = {}
        if kind == "int8":
            kq, ksc, _ = _quantized(k[0, :plen].float())
            vq, vsc, _ = _quantized(v[0, :plen].float())
            src = ((bt_k, kq, ksc), (bt_v, vq, vsc))
            # the prefix the pages hold
            kp = chai_cache.dequant_rows(kq, ksc)[None]
            vp = chai_cache.dequant_rows(vq, vsc)[None]
            pool = torch.zeros(n_pool, kv, PAGE, hd, dtype=torch.int8,
                               device=dev)
            spool = torch.zeros(n_pool, kv, PAGE, device=dev)
            sc = dict(k_scale_pool=spool, v_scale_pool=spool)
        else:
            src = ((bt_k, k[0, :plen], None), (bt_v, v[0, :plen], None))
            kp, vp = k[:, :plen], v[:, :plen]
            pool = torch.zeros(n_pool, kv, PAGE, hd, dtype=torch.bfloat16,
                               device=dev)
        for bt, rows, scales in src:         # rows (plen, KV, hd)
            for j in range(n_pages):
                sl = slice(j * PAGE, (j + 1) * PAGE)
                pool[bt[0, j]] = rows[sl].transpose(0, 1)
                if scales is not None:
                    spool[bt[0, j]] = scales[sl].transpose(0, 1)
        ks_, vs_ = k[:, plen:], v[:, plen:]
        st_p = fk.paged_prefix_attend(q, pool, bt_k, bt_v, plen_t,
                                      softcap=GEMMA_CAP, **sc)
        st_s = fk.flash_prefill(q, ks_, vs_, softcap=GEMMA_CAP,
                                emit_state=True)
        got = kops.finalize_prefill_state(kops.merge_prefill_states(st_s,
                                                                    st_p))
        torch.cuda.synchronize()
        kf = torch.cat([kp.float(), ks_.float()], 1)
        vf = torch.cat([vp.float(), vs_.float()], 1)
        want = attn_mod.attention_fullseq(q.float(), kf, vf,
                                          positions[plen:], positions,
                                          attn_softcap=GEMMA_CAP)
        err = _hold(got, want)
        rec = dict(case=f"gemma2_suffix_prefill_{kind}_prefix{plen}_"
                        f"suffix{t}", q=list(q.shape), heads=[h, kv],
                   softcap=GEMMA_CAP, max_abs_err=err,
                   held_against="eager attention_fullseq over 384 "
                                "positions (fp32)")
        log(f"gemma2 suffix prefill ({kind} prefix pages, hd {hd}, cap "
            f"{GEMMA_CAP:g}): paged_prefix_attend + flash_prefill merged "
            f"against the eager attention over {plen + t} positions: "
            f"max_abs_err {err:.3e}")
        pargs = (q, pool, bt_k, bt_v, plen_t)
        pcase = dict(case=f"gemma2_layer_{kind}_plen{plen}",
                     **prefix_case(*pargs, softcap=GEMMA_CAP, **sc))
        pcall = lambda a=pargs, s_=sc: fk.paged_prefix_attend(  # noqa
            *a, softcap=GEMMA_CAP, **s_)
        pcase.update(device_ms=device_ms(pcall, "paged_prefix_attend_"
                                         "kernel"),
                     plain_mode_device_ms=device_ms(
                         lambda a=pargs, s_=sc: fk.paged_prefix_attend(
                             *a, **s_), "paged_prefix_attend_kernel"),
                     single_call_ms=single_call_ms(pcall), layer_check=rec)
        _log_case("paged_prefix_attend", pcase)
        cases["paged_prefix_attend" + ("_int8" if kind == "int8"
                                       else "")] = pcase
        if kind == "bf16":
            fcase = dict(case=f"gemma2_layer_suffix{t}_state",
                         **flash_case(q, ks_, vs_, emit_state=True,
                                      library=True, softcap=GEMMA_CAP),
                         plain_mode_device_ms=device_ms(
                             lambda: fk.flash_prefill(q, ks_, vs_,
                                                      emit_state=True),
                             "flash_prefill_kernel"),
                         layer_check=rec)
            _log_case("flash_prefill", fcase)
            cases["flash_prefill"] = fcase
        del pool
    return cases


# ------------------------------------------- phase 3: the pipeline ----
PIPE_KERNELS = ("chai_qk", "chai_qk_i8", "paged_chai_qk", "row_softmax",
                "chai_av", "paged_chai_av")
# each pipeline kernel's CUDA function, as a torch.profiler trace names it
PIPE_FUNCS = {"chai_qk": "qk_kernel", "chai_qk_i8": "qk_kernel",
              "paged_chai_qk": "qk_kernel",
              "row_softmax": "row_softmax_kernel", "chai_av": "av_kernel",
              "paged_chai_av": "av_kernel"}


def _bound(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _valid_positions(p, s, window):
    """Positions a QK row at ``pos`` = p scores (idx <= p, and p - idx <
    window when window > 0), within 0..s-1."""
    lo = max(0, p - window + 1) if window else 0
    return max(0, min(p, s - 1) - lo + 1)


def qk_bound(q, k, pos, s, *, window=0, k_scale=None, tables=()):
    """Least time for a QK kernel's work: every KV row's K elements (and
    int8 scales) at the valid positions read once, whatever reps share
    the row; q, pos and the block ``tables`` read and the (B, R, S) fp32
    scores written once; 2 * hd fp32 flops per (rep, valid position)."""
    b, r, hd = q.shape
    kv = k.shape[1]
    n_bytes = (q.numel() + pos.numel() + b * r * s
               + sum(t.numel() for t in tables)) * 4
    flops = 0
    for p in pos.tolist():
        n = _valid_positions(int(p), s, window)
        n_bytes += kv * n * (hd * k.element_size()
                             + (4 if k_scale is not None else 0))
        flops += 2 * r * n * hd
    return _bound(n_bytes, flops)


def softmax_bound(scores):
    """One read and one write of the (B, R, S) fp32 rows."""
    return _bound(2 * scores.numel() * 4, 3 * scores.numel())


def av_bound(a, v, h2c, *, tables=()):
    """Least time for an AV kernel's work: the A rows the heads name and
    every head's V row over all S read once (``v`` gives the element
    size), h2c and ``tables`` read and the (B, H, hd) fp32 output written
    once; 2 * hd fp32 flops per (head, position)."""
    b, _, s = a.shape
    h, hd = h2c.shape[-1], v.shape[-1]
    h2c = h2c.expand(b, h) if h2c.ndim == 1 else h2c
    rows = sum(len(set(r.tolist())) for r in h2c)
    n_bytes = ((rows * s + b * h * hd + h2c.numel()
                + sum(t.numel() for t in tables)) * 4
               + b * h * s * hd * v.element_size())
    return _bound(n_bytes, 2 * b * h * s * hd)


def pipe_case(name, call, plain, bound, *, library=None, profile=False):
    """``row_softmax`` against its plain version (2e-5), timed beside the
    library call (``torch.softmax``); returns (its record, the kernel's
    output). ``profile``: also its single-call and profiled device times,
    and the kernel's and the library's device times taken in turns in
    this process (kernel, library, three times each:
    ``device_ms_in_turns``)."""
    got = call()
    torch.cuda.synchronize()
    want = plain()
    rec = dict(max_abs_err=_hold(got, want), ms=time_ms(call),
               plain_ms=time_ms(plain), bound_ms=bound[0],
               bound_by=bound[1],
               library_ms=time_ms(library) if library else None)
    if library and profile:
        rec["library_device_ms"] = library_device_ms(library)
        turns = [(device_ms(call, PIPE_FUNCS[name]),
                  library_device_ms(library)) for _ in range(3)]
        rec["device_ms_in_turns"] = dict(
            kernel=[k for k, _ in turns], library=[x for _, x in turns])
    if profile:
        rec["single_call_ms"] = single_call_ms(call)
        rec["device_ms"] = device_ms(call, PIPE_FUNCS[name])
    return rec, got


# The pipeline's raw int8 codes, the QK pair's K and the AV pair's V:
# ``plain_int8`` of the float tensor x 40 (the share_values clustered
# V's cast, saturated at +-127), held over the codes' range: out / 127
# at 2e-5, the raw error recorded beside it.
CODE_SCALE = 40.0
CODE_RANGE = 127.0
QK_KERNELS = ("chai_qk", "chai_qk_i8", "paged_chai_qk")
QK_ROWS = ("chai_qk[int8]", "paged_chai_qk[int8]")
AV_ROWS = ("chai_av", "paged_chai_av", "chai_av[int8]", "paged_chai_av[int8]")
YARDSTICK = {
    "qk": ("index_select of the K rows the reps read (a pool first "
           "gathered through its table) + torch.matmul with the queries in "
           "K's dtype (bf16 for int8 codes) + the row scales and 1/sqrt(hd) "
           "+ masked_fill: five calls, never on the path; not a library "
           "call of the function (none takes the rep -> K row map and the "
           "-2e38 mask)"),
    "av": ("torch.gather of the A rows the heads name (A cast to V's "
           "dtype beforehand) + torch.matmul over V: two calls, never on "
           "the path; not a library call of the function (none computes "
           "the h2c gather)")}
_FLUSH = {}


def l2_flush():
    """Read 256 MB, 5x the H100's 50 MB L2, so the next call finds its
    inputs in device memory only. A read leaves no dirty lines, whose
    write-back would slow the next call."""
    buf = _FLUSH.get("buf")
    if buf is None:
        buf = _FLUSH["buf"] = torch.ones(256 << 20, dtype=torch.uint8,
                                         device="cuda")
    buf.sum(dtype=torch.int32)


def cold_device_ms(fn, kernel):
    """``device_ms`` of ``kernel`` with the L2 flushed before every call
    (the flush's own kernel is not counted)."""
    return device_ms(lambda: (l2_flush(), fn()), kernel)


def qk_yardstick(q, k, pos, *, reps_per_group=1, window=0, k_scale=None,
                 bt=None):
    """The QK yardstick (``YARDSTICK["qk"]``) on these inputs: K dense
    (B, KV, S, hd), or a pool (nP, KV, page, hd) read through ``bt``."""
    b, r, hd = q.shape
    rows = torch.arange(r, device=q.device) // reps_per_group
    dt = torch.bfloat16 if k.dtype == torch.int8 else k.dtype
    qd = q.to(dt)[..., None]
    s = k.shape[2] if bt is None else bt.shape[1] * k.shape[2]
    idx = torch.arange(s, device=q.device)
    p = pos.long()[:, None]
    mask = idx[None] > p
    if window:
        mask |= p - idx[None] >= window
    mask = mask[:, None, :]
    ks = None if k_scale is None else k_scale.index_select(1, rows)
    scale = 1.0 / math.sqrt(hd)

    def call():
        if bt is None:
            kr = k.index_select(1, rows)
        else:
            kr = k[bt.long()].index_select(2, rows).movedim(1, 2).reshape(
                b, r, s, hd)
        sc = torch.matmul(kr.to(dt), qd)[..., 0].float()
        sc = (sc * ks if ks is not None else sc) * scale
        return sc.masked_fill_(mask, kref.NEG_INF)
    return call


def av_yardstick(a, v, h2c):
    """The AV yardstick (``YARDSTICK["av"]``) on these inputs, or None for
    int8 V (no float matmul reads int8 codes)."""
    if v.dtype == torch.int8:
        return None
    b, h = v.shape[:2]
    idx = (h2c.expand(b, h) if h2c.ndim == 1 else h2c).long()
    idx = idx[..., None].expand(b, h, a.shape[-1])
    a_v = a.to(v.dtype)
    return lambda: torch.matmul(torch.gather(a_v, 1, idx)[:, :, None, :], v)


def stage_case(name, call, plain, bound, *, codes=False, dense=None,
               yard=None, profile=False, cold=False):
    """One QK or AV kernel against its plain version (2e-5; raw int8
    codes over their range, out / 127, the raw error recorded; a QK
    kernel's masked entries ``torch.equal`` to -2e38 where the plain
    version has them and nowhere else), launched twice (``torch.equal``)
    and, with ``dense`` (the dense kernel's output on the same logical
    K or V at ts == page), ``torch.equal`` to it; the yardstick timed
    beside it. ``profile``: single-call and profiled device times, the
    yardstick's device time; ``cold``: the device time with the L2
    flushed before every call. Returns (its record, its output)."""
    got = call()
    torch.cuda.synchronize()
    want = plain()
    rec = {}
    if name in QK_KERNELS:
        masked = want == kref.NEG_INF
        if not torch.equal(got == kref.NEG_INF, masked):
            raise AssertionError(f"{name}: masked entries differ from the "
                                 "plain version's")
        rec["masked_entries"] = int(masked.sum())
    raw = _max_err(got, want)
    err = (_hold(got / CODE_RANGE, want / CODE_RANGE) if codes
           else _hold(got, want))
    _bitwise(f"{name} launched twice", call(), got)
    rec.update(max_abs_err=err, raw_max_abs_err=raw, repeat_bitwise=True)
    if codes:
        rec["held"] = f"out / {CODE_RANGE:g}"
    if dense is not None:
        _bitwise(f"{name} against the dense kernel at ts = page", got,
                 dense)
        rec["bitwise_equal_dense"] = True
    rec.update(ms=time_ms(call), plain_ms=time_ms(plain), bound_ms=bound[0],
               bound_by=bound[1], library_ms=None)
    if yard is not None:
        rec.update(yardstick=YARDSTICK["qk" if name in QK_KERNELS else "av"],
                   yardstick_ms=time_ms(yard))
    if profile:
        rec.update(single_call_ms=single_call_ms(call),
                   device_ms=device_ms(call, PIPE_FUNCS[name]))
        if yard is not None:
            rec["yardstick_device_ms"] = library_device_ms(yard)
    if cold:
        rec["cold_device_ms"] = cold_device_ms(call, PIPE_FUNCS[name])
    return rec, got


def _log_stage(name, rec):
    held = f", held {rec['held']}" if "held" in rec else ""
    log(f"{name} {rec['case']}: max_abs_err {rec['max_abs_err']:.3e} (raw "
        f"{rec['raw_max_abs_err']:.3e}{held}); device {rec.get('device_ms')} "
        f"ms, L2 cold {rec.get('cold_device_ms')} ms, back to back "
        f"{rec['ms']:.4f} ms, "
        f"single call {rec.get('single_call_ms')}; bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); plain "
        f"{rec['plain_ms']:.4f} ms; yardstick {rec.get('yardstick_ms')} ms "
        f"(device {rec.get('yardstick_device_ms')})"
        + ("; paged == dense bitwise" if rec.get("bitwise_equal_dense")
           else ""))


def null_past_pos(bt, pos):
    """Block tables as the engine holds them: entries past a row's last
    live page name the null page 0."""
    bt = bt.clone()
    for i, p in enumerate(pos.tolist()):
        bt[i, max(int(p), 0) // PAGE + 1:] = 0
    return bt


def pipeline_stage_cases(tag, q, k, v, h2c, pos, *, rpg, window=0,
                         pages=None, h2c_flat=None, int8_v=False,
                         mask_row=True, profile=False):
    """The six pipeline kernels on one decode input, each against its
    plain version. ``k``/``v``: dense (B, KV, S, hd) / (B, H, S, hd), and
    with ``pages`` = (k_pool, bt_k, v_pool, bt_v) holding the same logical
    K/V the paged kernels run on the pools too (paged QK and paged AV
    bitwise equal to the dense kernels); ``chai_qk_i8`` on K from
    ``quant_rows``, and ``chai_qk`` / ``paged_chai_qk`` once more on K's
    raw int8 codes (``CODE_SCALE``; rows ``*_qk[int8]``). ``mask_row``: a
    second softmax launch with row 1's scores masked everywhere, which
    must give zeros. ``h2c_flat`` ((H,)): the AV kernels once more with a
    batch-shared h2c. ``int8_v``: the AV kernels once more on V's raw
    int8 codes (rows ``*_av[int8]``). Every QK and AV launch is repeated
    (bitwise) and timed beside its yardstick. ``profile``: single-call,
    profiled and L2-cold device times too. Returns {row: [records]}."""
    out = {n: [] for n in PIPE_KERNELS + QK_ROWS + AV_ROWS[2:]}
    s = k.shape[2]

    def add(name, rec, **extra):
        rec = dict(case=f"{tag}", q=list(q.shape), k=list(k.shape),
                   dtype=str(k.dtype), pos=pos.tolist(), window=window,
                   **extra, **rec)
        out[name].append(rec)
        log(f"{name} {rec['case']}: max_abs_err {rec['max_abs_err']:.3e} "
            f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            + (f" library {rec['library_ms']:.4f} ms"
               if rec["library_ms"] is not None else "")
            + (f" yardstick {rec['yardstick_ms']:.4f} ms"
               if "yardstick_ms" in rec else "")
            + (f" device {rec['device_ms']}" if "device_ms" in rec else "")
            + (f" masked {rec['masked_entries']}" if "masked_entries" in rec
               else ""))

    kw = dict(reps_per_group=rpg, window=window)
    k8 = chai_cache.plain_int8(k.float() * CODE_SCALE)
    dense_qk = {}
    for kk, row in ((k, "chai_qk"), (k8, "chai_qk[int8]")):
        rec, dense_qk[kk.dtype] = stage_case(
            "chai_qk", lambda: ck.chai_qk(q, kk, pos, ts=PAGE, **kw),
            lambda: kref.chai_qk_ref(q, kk, pos, **kw),
            qk_bound(q, kk, pos, s, window=window),
            codes=kk.dtype == torch.int8, yard=qk_yardstick(q, kk, pos, **kw),
            profile=profile, cold=profile)
        add(row, rec, k_dtype=str(kk.dtype))
    sc = dense_qk[k.dtype]
    kq, ks = chai_cache.quant_rows(k)
    rec, _ = stage_case(
        "chai_qk_i8", lambda: ck.chai_qk_i8(q, kq, ks, pos, ts=PAGE, **kw),
        lambda: kref.chai_qk_i8_ref(q, kq, ks, pos, **kw),
        qk_bound(q, kq, pos, s, window=window, k_scale=ks),
        yard=qk_yardstick(q, kq, pos, k_scale=ks, **kw), profile=profile,
        cold=profile)
    add("chai_qk_i8", rec)
    rec, a = pipe_case(
        "row_softmax", lambda: ck.row_softmax(sc),
        lambda: kref.row_softmax_ref(sc), softmax_bound(sc),
        library=lambda: torch.softmax(sc, -1), profile=profile)
    add("row_softmax", rec)
    if mask_row:
        masked = sc.clone()
        masked[1] = kref.NEG_INF
        rec, am = pipe_case(
            "row_softmax", lambda: ck.row_softmax(masked),
            lambda: kref.row_softmax_ref(masked), softmax_bound(masked),
            library=lambda: torch.softmax(masked, -1))
        if am[1].any():
            raise AssertionError("row_softmax: a fully masked row is not "
                                 "zeros")
        add("row_softmax", rec, masked_row=1)
    v8 = chai_cache.plain_int8(v.float() * CODE_SCALE) if int8_v else None
    dense_av = {}
    for vv, row in ((v, "chai_av"), (v8, "chai_av[int8]")):
        for idx, label in ((h2c, "h2c_BH"), (h2c_flat, "h2c_H")):
            if idx is None or vv is None:
                continue
            first = profile and label == "h2c_BH"
            rec, dense_av[vv.dtype, label] = stage_case(
                "chai_av", lambda: ck.chai_av(a, vv, idx, ts=PAGE),
                lambda: kref.chai_av_ref(a, vv, idx), av_bound(a, vv, idx),
                codes=vv.dtype == torch.int8, yard=av_yardstick(a, vv, idx),
                profile=first, cold=first)
            add(row, rec, h2c=label, v_dtype=str(vv.dtype))
    if pages is None:
        return out
    k_pool, bt_k, v_pool, bt_v = pages
    for pool, row in ((k_pool, "paged_chai_qk"),
                      (chai_cache.plain_int8(k_pool.float() * CODE_SCALE),
                       "paged_chai_qk[int8]")):
        rec, _ = stage_case(
            "paged_chai_qk",
            lambda: ck.paged_chai_qk(q, pool, bt_k, pos, **kw),
            lambda: kref.paged_chai_qk_ref(q, pool, bt_k, pos, **kw),
            qk_bound(q, pool, pos, s, window=window, tables=(bt_k,)),
            codes=pool.dtype == torch.int8, dense=dense_qk[pool.dtype],
            yard=qk_yardstick(q, pool, pos, bt=bt_k, **kw), profile=profile,
            cold=profile)
        add(row, rec, k_pool=list(pool.shape), k_dtype=str(pool.dtype))
    v_pool8 = (chai_cache.plain_int8(v_pool.float() * CODE_SCALE) if int8_v
               else None)
    for pool, vv, row in ((v_pool, v, "paged_chai_av"),
                          (v_pool8, v8, "paged_chai_av[int8]")):
        for idx, label in ((h2c, "h2c_BH"), (h2c_flat, "h2c_H")):
            if idx is None or pool is None:
                continue
            first = profile and label == "h2c_BH"
            rec, _ = stage_case(
                "paged_chai_av",
                lambda: ck.paged_chai_av(a, pool, bt_v, idx),
                lambda: kref.paged_chai_av_ref(a, pool, bt_v, idx),
                av_bound(a, pool, idx, tables=(bt_v,)),
                codes=pool.dtype == torch.int8,
                dense=dense_av[pool.dtype, label],
                yard=av_yardstick(a, vv, idx), profile=first, cold=first)
            add(row, rec, v_pool=list(pool.shape), h2c=label,
                v_dtype=str(pool.dtype))
    return out


def pipeline_kernel_checks():
    """The six pipeline kernels on synthetic inputs at the full-width
    shapes (B = 4, S = 1024, hd = 128): MHA (R = k_max = 25 reps of 32
    heads, fp32 and bf16, and with a window of 200) and GQA (8 KV groups
    of 5 reps of 6 heads, nemotron-4-15b's r_max, bf16); int8 K from the
    port's ``quant_rows``; the QK pair also on K's raw int8 codes; row 0
    at pos 2; shuffled pages with the null page 0 past each row's pos;
    row 1's scores masked everywhere before the softmax; h2c (B, H) and
    (H,); the AV pair also on V's raw int8 codes (all but the windowed
    case); the bf16 MHA and GQA cases with device times (profiled, single
    call, L2 cold). Then the QK and AV pairs and ``row_softmax`` at S =
    65,536 (``long_qk_checks``, ``long_av_checks``,
    ``long_softmax_checks``)."""
    gen = torch.Generator("cuda").manual_seed(6)
    k_max = get_config(ARCH).k_max
    cases = {n: [] for n in PIPE_KERNELS + QK_ROWS + AV_ROWS[2:]}
    for tag, kw, window in (
            ("mha_fp32", dict(b=4, h=32, kv=k_max, rpg=1,
                              dtype=torch.float32, empty_rep=7), 0),
            ("mha_bf16", dict(b=4, h=32, kv=k_max, rpg=1,
                              dtype=torch.bfloat16, empty_rep=7), 0),
            ("mha_bf16_window200", dict(b=4, h=32, kv=k_max, rpg=1,
                                        dtype=torch.bfloat16, empty_rep=7),
             200),
            ("gqa_bf16", dict(b=4, h=48, kv=8, rpg=5, dtype=torch.bfloat16,
                              empty_rep=None), 0)):
        q, k, v, h2c, pos = synthetic_case(gen, s=MAX_SEQ, hd=128, **kw)
        if kw["rpg"] > 1:      # the pipeline's AV takes per-head V rows
            v = v.repeat_interleave(kw["h"] // kw["kv"], dim=1)
        pos[0] = 2
        k_pool, bt_k = to_pages(gen, k)
        v_pool, bt_v = to_pages(gen, v)
        pages = (k_pool, null_past_pos(bt_k, pos), v_pool,
                 null_past_pos(bt_v, pos))
        got = pipeline_stage_cases(tag, q, k, v, h2c, pos, rpg=kw["rpg"],
                                   window=window, pages=pages,
                                   h2c_flat=h2c[2] if tag == "mha_fp32"
                                   else None, int8_v=not window,
                                   profile=tag in ("mha_bf16", "gqa_bf16"))
        for name in got:
            cases[name] += got[name]
    for long in (long_qk_checks(), long_av_checks(),
                 long_softmax_checks()):
        for name, got in long.items():
            cases[name] += got
    return cases


def long_softmax_checks():
    """``row_softmax`` on the QK pair's long rows (B 1, 25 reps, S =
    65,536: one cluster of 8 blocks a row, read once) and on rows twice
    as long (S = 131,072: streamed, read twice): scores of std 2, row 1
    masked from position 40,000 on and row 2 masked everywhere (zeros);
    against its plain version (2e-5), and again scaled by S (y * S at
    2e-5: the mean entry is 1 / S, below the plain tolerance, so an entry
    the kernel got wrong would pass unscaled), launched twice
    ``torch.equal``, its
    device time taken in turns beside ``torch.softmax`` (three each) with
    its bound. Returns {"row_softmax": [records]}."""
    gen = torch.Generator("cuda").manual_seed(13)
    recs = []
    for tag, s in (("long_65536", 65536), ("streamed_131072", 131072)):
        sc = 2 * torch.randn(1, 25, s, generator=gen, device="cuda")
        sc[0, 1, 40000:] = kref.NEG_INF
        sc[0, 2] = kref.NEG_INF
        rec, got = pipe_case(
            "row_softmax", lambda: ck.row_softmax(sc),
            lambda: kref.row_softmax_ref(sc), softmax_bound(sc),
            library=lambda: torch.softmax(sc, -1), profile=True)
        _bitwise(f"row_softmax {tag}: two launches", ck.row_softmax(sc), got)
        scaled_err = _hold(got * s, kref.row_softmax_ref(sc) * s)
        if got[0, 2].any():
            raise AssertionError(f"row_softmax {tag}: a fully masked row is "
                                 "not zeros")
        plan = ck.softmax_launch_config(25, s)
        rec.update(case=tag, scores=list(sc.shape), masked_row=2,
                   repeat_bitwise=True, plan=plan._asdict(),
                   max_abs_err_times_s=scaled_err)
        log(f"row_softmax {tag}: plan {plan._asdict()}; max_abs_err "
            f"{rec['max_abs_err']:.3e}, times S {scaled_err:.3e}, two "
            f"launches bitwise; device "
            f"{rec['device_ms']} ms (bound {rec['bound_ms']:.4f} ms), in "
            f"turns kernel {rec['device_ms_in_turns']['kernel']} against "
            f"torch.softmax {rec['device_ms_in_turns']['library']} ms")
        recs.append(rec)
        del sc, got
        torch.cuda.empty_cache()
    return {"row_softmax": recs}


def long_qk_checks():
    """chai_qk, paged_chai_qk and chai_qk_i8 at S = 65,536, B = 1, R = 25
    (chai-llama-7b's k_max reps, MHA), hd 128, pos S - 1 (every position
    valid): bf16 K, its int8 codes with row scales (``quant_rows``;
    ``chai_qk_i8``) and its raw int8 codes (``CODE_SCALE``; rows
    ``*_qk[int8]``). Each against its plain version, launched twice,
    paged == dense bitwise, device times (K is 419 MB in bf16, 210 MB in
    int8: L2 cold by size) beside the bound and the yardstick. Returns
    {row: [records]}."""
    gen = torch.Generator("cuda").manual_seed(25)
    b, r, s, hd = 1, get_config(ARCH).k_max, 65536, 128
    q = torch.randn(b, r, hd, generator=gen, device="cuda")
    k = torch.randn(b, r, s, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
    out = {n: [] for n in QK_KERNELS + QK_ROWS}

    def add(name, rec, kk):
        rec = dict(case="long_s65536", q=list(q.shape), k=list(kk.shape),
                   k_dtype=str(kk.dtype), pos=pos.tolist(), **rec)
        rec["cold_device_ms"] = rec["device_ms"]      # cold by size
        out[name].append(rec)
        _log_stage(name, rec)

    kq, ks = chai_cache.quant_rows(k)
    rec, _ = stage_case(
        "chai_qk_i8", lambda: ck.chai_qk_i8(q, kq, ks, pos, ts=PAGE),
        lambda: kref.chai_qk_i8_ref(q, kq, ks, pos),
        qk_bound(q, kq, pos, s, k_scale=ks),
        yard=qk_yardstick(q, kq, pos, k_scale=ks), profile=True)
    add("chai_qk_i8", rec, kq)
    del kq, ks
    for kk, mode in ((k, ""), (None, "[int8]")):
        if kk is None:
            kk = chai_cache.plain_int8(k.float() * CODE_SCALE)
        codes = kk.dtype == torch.int8
        pool, bt = to_pages(gen, kk, n_extra=1)
        rec, dense = stage_case(
            "chai_qk", lambda: ck.chai_qk(q, kk, pos, ts=PAGE),
            lambda: kref.chai_qk_ref(q, kk, pos), qk_bound(q, kk, pos, s),
            codes=codes, yard=qk_yardstick(q, kk, pos), profile=True)
        add("chai_qk" + mode, rec, kk)
        rec, _ = stage_case(
            "paged_chai_qk", lambda: ck.paged_chai_qk(q, pool, bt, pos),
            lambda: kref.paged_chai_qk_ref(q, pool, bt, pos),
            qk_bound(q, pool, pos, s, tables=(bt,)), codes=codes,
            dense=dense, yard=qk_yardstick(q, pool, pos, bt=bt),
            profile=True)
        add("paged_chai_qk" + mode, rec, pool)
        del pool, dense
        torch.cuda.empty_cache()
    return out


def long_av_checks():
    """chai_av and paged_chai_av at S = 65,536, B = 1, H = 32, hd 128
    (chai-llama-7b's heads over k_max = 25 A rows), bf16 V and its raw
    int8 codes: each against its plain version, launched twice, paged ==
    dense bitwise at ts = page, device times (V alone is 537 MB in bf16,
    268 MB in int8: L2 cold by size) beside the bound and the yardstick.
    Returns {row: [records]}."""
    gen = torch.Generator("cuda").manual_seed(24)
    b, h, r, s, hd = 1, 32, get_config(ARCH).k_max, 65536, 128
    a = torch.softmax(2 * torch.randn(b, r, s, generator=gen, device="cuda"),
                      -1)
    h2c = torch.randint(0, r, (b, h), generator=gen, device="cuda",
                        dtype=torch.int32)
    v = torch.randn(b, h, s, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = {n: [] for n in AV_ROWS}
    for vv, mode in ((v, ""), (None, "[int8]")):
        if vv is None:
            vv = chai_cache.plain_int8(v.float() * CODE_SCALE)
        int8 = vv.dtype == torch.int8
        pool, bt = to_pages(gen, vv, n_extra=1)
        rec, dense = stage_case(
            "chai_av", lambda: ck.chai_av(a, vv, h2c, ts=PAGE),
            lambda: kref.chai_av_ref(a, vv, h2c), av_bound(a, vv, h2c),
            codes=int8, yard=av_yardstick(a, vv, h2c), profile=True)
        prec, _ = stage_case(
            "paged_chai_av", lambda: ck.paged_chai_av(a, pool, bt, h2c),
            lambda: kref.paged_chai_av_ref(a, pool, bt, h2c),
            av_bound(a, pool, h2c, tables=(bt,)), codes=int8, dense=dense,
            yard=av_yardstick(a, vv, h2c), profile=True)
        for name, rc in (("chai_av", rec), ("paged_chai_av", prec)):
            rc = dict(case=f"long_s65536{mode}", a=list(a.shape),
                      v=list(vv.shape), v_dtype=str(vv.dtype), **rc)
            rc["cold_device_ms"] = rc["device_ms"]   # cold by size
            out[name + mode].append(rc)
            _log_stage(name + mode, rc)
        del pool, dense
        torch.cuda.empty_cache()
    return out


# ------------------------------------- phase 3: the flash decode pair ----
# Each flash decode kernel's CUDA function, as a torch.profiler trace names
# it.
FLASH_FUNCS = {"flash_decode": "flash_decode_kernel",
               "paged_decode": "paged_decode_kernel"}


def flash_decode_bound(q, k, pos, *, window=0, s=None, page=0):
    """Least time for a flash decode's work: q read, the (B, H, hd) fp32
    output written, and per batch row the K and V rows of its KV groups at
    the live positions (idx <= pos, and pos - idx < window) read once,
    with, paged (``page``), the two table entries of each live page; the
    QK and AV multiply-adds in fp32. ``k``: the cache or the pool (element
    size, KV rows); ``s``: the logical length."""
    b, h, hd = q.shape
    kv, es = k.shape[1], k.element_size()
    n_bytes = q.numel() * q.element_size() + b * 4 + b * h * hd * 4
    flops = 0
    for p in pos.tolist():
        hi = min(int(p), s - 1)
        lo = max(0, int(p) - window + 1) if window else 0
        n = max(0, hi - lo + 1)
        n_bytes += 2 * kv * n * hd * es
        if page and n:
            n_bytes += 2 * 4 * (hi // page - lo // page + 1)
        flops += 4 * h * n * hd
    return _bound(n_bytes, flops)


def sdpa_call(q, k, v, pos, window=0):
    """PyTorch's ``scaled_dot_product_attention`` computing
    ``flash_decode``'s function on the same inputs (one query per head,
    GQA through ``enable_gqa``, the positions as a boolean mask): the
    library yardstick, timed beside the kernel and never on the path."""
    b, h, hd = q.shape
    s = k.shape[2]
    idx = torch.arange(s, device=q.device)
    p = pos.long()[:, None]
    valid = idx[None, :] <= p
    if window:
        valid &= (p - idx[None, :]) < window
    mask = valid[:, None, None, :]
    q4 = q.to(k.dtype)[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q4, k, v, attn_mask=mask,
                        enable_gqa=k.shape[1] != h)[:, :, 0]


def flash_decode_case(name, args, *, window=0, ts=0, library=False,
                      profile=False):
    """One flash decode kernel (``name``) against its plain version on
    ``args`` (2e-5: both compute in fp32 from the same inputs); the case's
    record with back-to-back, plain and bound times, and with ``profile``
    the single-call and profiled device times, and with ``library`` the
    SDPA call's time (dense only)."""
    if name == "flash_decode":
        q, k, v, pos = args
        call = lambda: fk.flash_decode(q, k, v, pos, window=window,  # noqa
                                       ts=ts)
        plain = lambda: kref.flash_decode_ref(q, k, v, pos,  # noqa: E731
                                              window=window)
        bound, by = flash_decode_bound(q, k, pos, window=window,
                                       s=k.shape[2])
        shapes = dict(k=list(k.shape), ts=ts)
    else:
        q, pool, bt_k, bt_v, pos = args
        call = lambda: fk.paged_decode(q, pool, bt_k, bt_v, pos,  # noqa
                                       window=window)
        plain = lambda: kref.paged_decode_ref(q, pool, bt_k, bt_v, pos,  # noqa
                                              window=window)
        bound, by = flash_decode_bound(
            q, pool, pos, window=window, s=bt_k.shape[1] * pool.shape[2],
            page=pool.shape[2])
        shapes = dict(pool=list(pool.shape), page=pool.shape[2])
    got = call()
    torch.cuda.synchronize()
    err = _hold(got, plain())
    rec = dict(q=list(q.shape), dtype=str(args[1].dtype),
               q_dtype=str(q.dtype), window=window, pos=pos.tolist(),
               **shapes, max_abs_err=err, ms=time_ms(call),
               plain_ms=time_ms(plain), bound_ms=bound, bound_by=by)
    if profile:
        rec["single_call_ms"] = single_call_ms(call)
        rec["device_ms"] = device_ms(call, FLASH_FUNCS[name])
    if library:
        lib = sdpa_call(q, k, v, pos, window)
        rec["library_ms"] = time_ms(lib)
        rec["library_vs_kernel_max_abs_diff"] = _max_err(lib(), got)
        if profile:
            rec["library_device_ms"] = library_device_ms(lib)
    return rec, got


def _log_flash_decode(name, case):
    log(f"{name} {case['case']}: q {tuple(case['q'])} {case['q_dtype']}, "
        + (f"k {tuple(case['k'])} ts {case['ts']}" if "k" in case else
           f"pool {tuple(case['pool'])}")
        + f" {case['dtype']} window {case['window']}: max_abs_err "
        f"{case['max_abs_err']:.3e} kernel {case['ms']:.4f} ms plain "
        f"{case['plain_ms']:.4f} ms bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']})"
        + (f" splits {case['n_split']} x {case['tiles_per_split']} tiles;"
           " paged == dense, repeat == repeat: bitwise"
           if "n_split" in case else "")
        + (f" single call {case['single_call_ms']:.4f} ms, device "
           f"{case['device_ms']} ms" if "device_ms" in case else "")
        + (f" library (SDPA) {case['library_ms']:.4f} ms, device "
           f"{case.get('library_device_ms')} ms, SDPA vs kernel "
           f"{case['library_vs_kernel_max_abs_diff']:.3e}"
           if "library_ms" in case else ""))


def flash_decode_pair(tag, q, k, v, pos, *, window=0, page=PAGE,
                     library=False, profile=False, gen=None):
    """Both kernels on one logical cache: ``flash_decode`` on the dense
    K/V at ts == page, ``paged_decode`` on a pool holding the same rows
    at shuffled pages (table entries past each row's pos name the null
    page 0), their outputs bitwise equal. Returns {kernel: record}."""
    b, kv, s, hd = k.shape
    n = s // page
    n_pool = 2 * b * n + 5
    pool = torch.randn((n_pool, kv, page, hd), generator=gen,
                       device="cuda").to(k.dtype)
    ids = torch.randperm(n_pool - 1, generator=gen, device="cuda")[:2 * b * n]
    bt_k = (ids[:b * n] + 1).reshape(b, n).to(torch.int32)
    bt_v = (ids[b * n:] + 1).reshape(b, n).to(torch.int32)
    pool[bt_k.long()] = k.reshape(b, kv, n, page, hd).movedim(2, 1)
    pool[bt_v.long()] = v.reshape(b, kv, n, page, hd).movedim(2, 1)
    hi_page = (pos.long().clamp(max=s - 1) // page)[:, None]
    past = torch.arange(n, device="cuda")[None, :] > hi_page
    bt_k, bt_v = bt_k.masked_fill(past, 0), bt_v.masked_fill(past, 0)
    dense, d_out = flash_decode_case(
        "flash_decode", (q, k, v, pos), window=window, ts=page,
        library=library, profile=profile)
    paged, p_out = flash_decode_case(
        "paged_decode", (q, pool, bt_k, bt_v, pos), window=window,
        profile=profile)
    if not torch.equal(d_out, p_out):
        raise AssertionError(f"{tag}: paged_decode differs from flash_decode"
                             f" at ts == page: max abs diff "
                             f"{_max_err(d_out, p_out):.3e}")
    _bitwise(f"{tag} flash_decode: two launches", fk.flash_decode(
        q, k, v, pos, window=window, ts=page), d_out)
    _bitwise(f"{tag} paged_decode: two launches", fk.paged_decode(
        q, pool, bt_k, bt_v, pos, window=window), p_out)
    cfg = fk.flash_decode_launch_config(b, q.shape[1], kv, n, hd)
    lib_smem = build.load("flash_decode").flash_decode_smem_bytes(
        cfg.heads_per_block, hd)
    if lib_smem != cfg.smem_bytes:
        raise AssertionError(f"{tag}: the flash decode block takes "
                             f"{lib_smem} B of shared memory, the host's "
                             f"mirror says {cfg.smem_bytes}")
    out = {}
    for name, rec in (("flash_decode", dense), ("paged_decode", paged)):
        rec = dict(case=tag, **rec, n_split=cfg.n_split,
                   tiles_per_split=cfg.tiles_per_split,
                   bitwise_equal_dense=True, repeat_bitwise=True)
        out[name] = rec
        _log_flash_decode(name, rec)
    return out, (pool, bt_k, bt_v)


def flash_decode_checks():
    """``flash_decode`` and ``paged_decode`` against their plain versions:
    the reference's sweep shapes (``tests/test_kernels.py``: MHA, GQA 4:1,
    MQA, one tile, a window of 24; fp32 and bf16), the full-width
    chai-llama-7b shape (B 4, H = KV = 32, hd 128, S 1024, bf16) and
    nemotron-4-15b's (48 query heads over 8 KV heads); paged == dense
    bitwise at ts == page on every case; the null page poisoned with 999,
    and every dense position past pos, change no output bit. The
    full-width cases also time PyTorch's SDPA on the same inputs. Then the
    split-S cases at full width (bf16, page 16): several splits with a
    partial last one, a row at pos 0, nemotron's shape, and one row of
    S = 65,536, MHA and GQA. Every case launches each kernel twice: the
    two outputs must be equal bit for bit."""
    gen = torch.Generator("cuda").manual_seed(7)
    dev = "cuda"
    cases = {"flash_decode": [], "paged_decode": []}

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sweep = (("mha", 1, 4, 4, 32, 16, 8, 0), ("gqa4", 2, 8, 2, 64, 32, 16, 0),
             ("mqa", 3, 6, 1, 48, 8, 16, 0),
             ("single_tile", 2, 4, 4, 64, 32, 64, 0),
             ("window24", 2, 8, 4, 64, 16, 16, 24))
    for dtype in (torch.float32, torch.bfloat16):
        for tag, b, h, kv, s, hd, ts, window in sweep:
            q, k, v = (rand(b, h, hd, dtype=dtype),
                       rand(b, kv, s, hd, dtype=dtype),
                       rand(b, kv, s, hd, dtype=dtype))
            pos = torch.randint(1, s, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
            got, _ = flash_decode_pair(f"sweep_{tag}_{str(dtype)[6:]}", q,
                                       k, v, pos, window=window, page=ts,
                                       gen=gen)
            for name in cases:
                cases[name].append(got[name])
    for tag, h, kv in (("chai_llama_7b_full_width", 32, 32),
                       ("nemotron_gqa_full_width", 48, 8)):
        q = rand(4, h, 128, dtype=torch.bfloat16)
        k = rand(4, kv, MAX_SEQ, 128, dtype=torch.bfloat16)
        v = rand(4, kv, MAX_SEQ, 128, dtype=torch.bfloat16)
        pos = torch.randint(300, MAX_SEQ, (4,), generator=gen, device=dev,
                            dtype=torch.int32)
        got, (pool, bt_k, bt_v) = flash_decode_pair(
            f"synthetic_{tag}_bf16", q, k, v, pos, library=True,
            profile=True, gen=gen)
        for name in cases:
            cases[name].append(got[name])
        # poison: the null page, and every dense position past pos
        ref_p = fk.paged_decode(q, pool, bt_k, bt_v, pos)
        pool[0] = 999.0
        ref_d = fk.flash_decode(q, k, v, pos, ts=PAGE)
        past = (torch.arange(MAX_SEQ, device=dev)[None, :]
                > pos.long()[:, None])[:, None, :, None]
        kp, vp = k.masked_fill(past, 999.0), v.masked_fill(past, 999.0)
        torch.cuda.synchronize()
        if not (torch.equal(fk.paged_decode(q, pool, bt_k, bt_v, pos), ref_p)
                and torch.equal(fk.flash_decode(q, kp, vp, pos, ts=PAGE),
                                ref_d)):
            raise AssertionError(f"{tag}: a poisoned null page or position "
                                 "past pos changed the output")
        log(f"{tag}: null page 0 and positions past pos poisoned with 999: "
            "outputs bitwise unchanged")
    # the split-S cases (kernels/flash_attention.py:
    # flash_decode_launch_config): several splits with a partial last one
    # (S = 1008, 63 pages), a row at pos 0 (every split past the first
    # empty), nemotron's 48 heads over 8 KV groups, one row of S = 65,536
    for tag, b, h, kv, s, pos, profile in (
            ("split_partial_last", 4, 32, 32, 1008, (1007, 1000, 900, 885),
             False),
            ("split_row_at_pos0", 4, 32, 32, MAX_SEQ, (0, 10, 150, 700),
             False),
            ("split_nemotron_gqa", 4, 48, 8, 1008, (1007, 0, 500, 64),
             False),
            ("long_65536_mha", 1, 32, 32, 65536, (65535,), True),
            ("long_65536_gqa", 1, 48, 8, 65536, (65535,), True)):
        q = rand(b, h, 128, dtype=torch.bfloat16)
        k = rand(b, kv, s, 128, dtype=torch.bfloat16)
        v = rand(b, kv, s, 128, dtype=torch.bfloat16)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        got, _ = flash_decode_pair(tag, q, k, v, p, profile=profile,
                                   gen=gen)
        for name in cases:
            cases[name].append(got[name])
        del q, k, v, got
        torch.cuda.empty_cache()
    return cases


# ------------------------------------------ phase 3: the wide head ----
GEMMA3 = "gemma3-4b"           # qk_norm, 5 local : 1 global, hd 320
WIDE_ROWS = ("chai_fused_decode[wide]", "paged_chai_fused_decode[wide]",
             "flash_decode[wide]", "paged_decode[wide]")


def sdpa_backend(fn):
    """The kernels one SDPA call runs (``device_profile``) and the backend
    their names tell: flash, memory-efficient (cutlass), cuDNN, or the
    math path (matmul and softmax kernels)."""
    names = sorted(device_profile(fn, reps=3))
    low = " ".join(names).lower()
    backend = ("flash" if "flash" in low else
               "cudnn" if "cudnn" in low else
               "efficient" if ("fmha" in low or "efficient" in low
                               or "cutlass" in low) else "math")
    return backend, names


def _poisoned_fused(tag, q, k, v, h2c, pos, rpg, gen):
    """Positions past pos and the null page 0 poisoned with 999: the dense
    and paged fused kernels' outputs keep every bit (tables past each
    row's last live page name page 0, as the engine holds them)."""
    k_pool, bt_k = to_pages(gen, k)
    v_pool, bt_v = to_pages(gen, v)
    bt_k, bt_v = null_past_pos(bt_k, pos), null_past_pos(bt_v, pos)
    kw = dict(reps_per_group=rpg)
    ref_p = ck.paged_chai_fused_decode(q, k_pool, bt_k, v_pool, bt_v, h2c,
                                       pos, **kw)
    ref_d = ck.chai_fused_decode(q, k, v, h2c, pos, ts=PAGE, **kw)
    k_pool[0], v_pool[0] = 999.0, 999.0
    past = (torch.arange(k.shape[2], device="cuda")[None, :]
            > pos.long()[:, None])[:, None, :, None]
    kp, vp = k.masked_fill(past, 999.0), v.masked_fill(past, 999.0)
    got_p = ck.paged_chai_fused_decode(q, k_pool, bt_k, v_pool, bt_v, h2c,
                                       pos, **kw)
    got_d = ck.chai_fused_decode(q, kp, vp, h2c, pos, ts=PAGE, **kw)
    torch.cuda.synchronize()
    _bitwise(f"{tag}: paged, poisoned null page", got_p, ref_p)
    _bitwise(f"{tag}: dense, poisoned positions past pos", got_d, ref_d)
    _bitwise(f"{tag}: paged vs dense", ref_p, ref_d)
    log(f"{tag}: null page 0 and positions past pos poisoned with 999: "
        "outputs bitwise unchanged, paged == dense")


def wide_head_checks():
    """The four decode kernels gemma3-4b's global layers reach at head dim
    320 (the fused pair's wide-head libraries, the flash decode pair's
    kWideHd instance), on gemma3's layer layout (8 query heads over 4 KV
    groups, 2 reps a group; bf16, page 16), each at 2e-5 against its plain
    version: the fused pair through ``fused_pair_case`` (several splits
    with a partial last one, a WARMUP-like row with an all-null K table,
    one row of S = 65,536; paged == dense at page = tile, two launches and
    emit + empty merge + finalize bitwise; device, back-to-back and single
    times; the block's shared memory against the host's mirror), a null
    page and positions past pos poisoned with no bit changed; the flash
    pair through ``flash_decode_pair`` (gemma3's full-width decode at S
    1024 and a row of S = 65,536; paged == dense bitwise; SDPA timed
    beside ``flash_decode``, its backend named from its kernels), poisoned
    likewise. Then the hd-128 rows of the same four kernels on
    chai-llama-7b's shapes, timed in the same run. Every launch of a
    head-dim-320 case counts in the ``wide`` mode, and no hd-128 launch
    does. Returns ({wide row: [cases]}, {kernel: [hd-128 cases]})."""
    gen = torch.Generator("cuda").manual_seed(31)
    cfg = get_config(GEMMA3)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    _, rpg = clustering.chai_widths(cfg)
    if hd != ck.WIDE_HD or rpg != 2:
        raise AssertionError(f"{GEMMA3}: head_dim {hd}, r_max {rpg}")
    wide = {row: [] for row in WIDE_ROWS}
    narrow = {row.split("[")[0]: [] for row in WIDE_ROWS}
    for tag, b, s, pos, warm in (
            ("gemma3_splits_partial_last", 4, MAX_SEQ,
             (1023, 1000, 700, 385), False),
            ("gemma3_warmup_row", 4, MAX_SEQ, None, True),
            ("gemma3_long_65536", 1, 65536, (65535,), False)):
        q, k, v, h2c, p = synthetic_case(gen, b=b, h=h, kv=kv, rpg=rpg, s=s,
                                         hd=hd, dtype=torch.bfloat16,
                                         empty_rep=None)
        if pos is not None:
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        if warm:
            h2c[1] = 0
        before = dict(ck.MODE_LAUNCHES)
        recs = fused_pair_case(f"wide_{tag}", q, k, v, h2c, p, rpg=rpg,
                               gen=gen, null_k_rows=(1,) if warm else (),
                               profile=True)
        for name in ("chai_fused_decode", "paged_chai_fused_decode"):
            n_wide = (ck.MODE_LAUNCHES.get(f"{name}[wide]", 0)
                      - before.get(f"{name}[wide]", 0))
            if not n_wide:
                raise AssertionError(f"{tag} {name}: no launch counted in "
                                     "the wide mode")
            wide[f"{name}[wide]"].append(recs[name])
        if not warm:
            _poisoned_fused(f"wide_{tag}", q, k, v, h2c, p, rpg, gen)
        del q, k, v
        torch.cuda.empty_cache()
    for tag, b, s, pos in (("gemma3_full_width", 4, MAX_SEQ, None),
                           ("gemma3_long_65536", 1, 65536, (65535,))):
        q = torch.randn(b, h, hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k = torch.randn(b, kv, s, hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
        v = torch.randn(b, kv, s, hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
        p = (torch.randint(300, s, (b,), generator=gen, device="cuda",
                           dtype=torch.int32) if pos is None
             else torch.tensor(pos, dtype=torch.int32, device="cuda"))
        got, (pool, bt_k, bt_v) = flash_decode_pair(
            f"wide_{tag}_bf16", q, k, v, p, library=True, profile=True,
            gen=gen)
        backend, names = sdpa_backend(sdpa_call(q, k, v, p))
        for name in ("flash_decode", "paged_decode"):
            got[name].update(library_backend=backend,
                             library_kernels=names)
            wide[f"{name}[wide]"].append(got[name])
        log(f"wide_{tag}: SDPA at head dim {hd} runs the {backend} backend"
            f" (its flash backend stops at head dim 256): kernels {names}")
        ref_p = fk.paged_decode(q, pool, bt_k, bt_v, p)
        ref_d = fk.flash_decode(q, k, v, p, ts=PAGE)
        pool[0] = 999.0
        past = (torch.arange(s, device="cuda")[None, :]
                > p.long()[:, None])[:, None, :, None]
        kp, vp = k.masked_fill(past, 999.0), v.masked_fill(past, 999.0)
        torch.cuda.synchronize()
        _bitwise(f"wide_{tag}: paged_decode, poisoned null page",
                 fk.paged_decode(q, pool, bt_k, bt_v, p), ref_p)
        _bitwise(f"wide_{tag}: flash_decode, poisoned positions past pos",
                 fk.flash_decode(q, kp, vp, p, ts=PAGE), ref_d)
        log(f"wide_{tag}: null page 0 and positions past pos poisoned with "
            "999: outputs bitwise unchanged")
        del q, k, v, kp, vp, pool
        torch.cuda.empty_cache()
    # the hd-128 rows in the same run: chai-llama-7b's full-width shapes
    full = get_config(ARCH)
    before = dict(ck.MODE_LAUNCHES)
    q, k, v, h2c, p = synthetic_case(gen, b=4, h=32, kv=full.k_max, rpg=1,
                                     s=MAX_SEQ, hd=128,
                                     dtype=torch.bfloat16, empty_rep=7)
    recs = fused_pair_case("narrow_llama_hd128", q, k, v, h2c, p, rpg=1,
                           gen=gen, profile=True)
    for name, rec in recs.items():
        narrow[name].append(rec)
    q, k, v = (torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for shape in ((4, 32, 128), (4, 32, MAX_SEQ, 128),
                             (4, 32, MAX_SEQ, 128)))
    got, _ = flash_decode_pair("narrow_llama_hd128_bf16", q, k, v, p,
                               library=True, profile=True, gen=gen)
    for name, rec in got.items():
        narrow[name].append(rec)
    if any("wide" in key and n != before.get(key, 0)
           for key, n in ck.MODE_LAUNCHES.items()):
        raise AssertionError("an hd-128 launch counted in the wide mode")
    for row, cases in wide.items():
        c, n = cases[0], narrow[row.split("[")[0]][0]
        log(f"{row} beside hd 128, same run: device {c.get('device_ms')}"
            f" ms against {n.get('device_ms')} ms, back to back "
            f"{c['ms']:.4f} against {n['ms']:.4f} ms, single call "
            f"{c.get('single_call_ms')} against "
            f"{n.get('single_call_ms')} ms; bound {c['bound_ms']:.4f} "
            f"against {n['bound_ms']:.4f} ms")
    return wide, narrow


# ------------------------------------------------------------ phase 4 ----
def reduced_cfg(arch=ARCH):
    """The reduced model of phase 4: 2 layers, fp32. nemotron-4-15b at 12
    heads of d_model 96: 2 KV groups of 6 heads, head_dim 8 (the default
    d_model 64 would give head_dim 5; the kernels need an even one)."""
    kw = dict(n_heads=12, d_model=96) if arch == NEMO else {}
    return reduced(get_config(arch), n_layers=2, **kw)


def reduced_reference_check(arch=ARCH):
    """The reduced model on the card (kernel path) against the same model
    on the CPU (plain path), teacher-forced: prefill, 5 WARMUP steps,
    membership from the CPU buffer used on both, 3 STEADY steps. An arch
    without CHAI (rwkv6-1.6b: no attention layer) takes 8 plain decode
    steps after the prefill instead."""
    cfg = reduced_cfg(arch)
    if not chai_applies(cfg):
        return reduced_plain_check(cfg)
    b, s = 3, 64
    params_cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params_gpu = {g: {n: t.cuda() for n, t in grp.items()}
                  for g, grp in params_cpu.items()}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, 32)))
    lens = torch.tensor([32, 19, 5])
    prefill = steps.make_serve_prefill(cfg, b, s)
    mha = steps.make_serve_step(cfg, chai=False, decode_ts=PAGE)
    chai = steps.make_serve_step(cfg, chai=True, decode_ts=PAGE)
    worst = 0.0

    def hold(lg, lc):
        nonlocal worst
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))

    lc, sc = prefill(params_cpu, {"tokens": toks, "true_lens": lens})
    lg, sg = prefill(params_gpu, {"tokens": toks.cuda(),
                                  "true_lens": lens.cuda()})
    hold(lg, lc)
    sc = chai_cache.add_score_buffer(sc, cfg, b)
    sg = chai_cache.add_score_buffer(sg, cfg, b)
    nxt = lc.argmax(-1)
    for _ in range(cfg.chai.warmup_tokens):
        lc, sc = mha(params_cpu, {"tokens": nxt}, sc)
        lg, sg = mha(params_gpu, {"tokens": nxt.cuda()}, sg)
        hold(lg, lc)
        nxt = lc.argmax(-1)
    sc, scores = chai_cache.pop_score_buffer(sc)
    sg, scores_g = chai_cache.pop_score_buffer(sg)
    torch.testing.assert_close(scores_g.cpu(), scores, atol=1e-5, rtol=1e-4)
    ctx = clustering.identify_membership(scores, cfg)
    ctx_g = clustering.identify_membership(scores.cuda(), cfg)
    for key in ctx:   # same buffer -> same membership on either device
        if not torch.equal(ctx_g[key].cpu(), ctx[key]):
            raise AssertionError(f"membership {key} differs cpu vs cuda")
    sc = chai_cache.compact_kv(sc, ctx, cfg)
    sg = chai_cache.compact_kv(sg, ctx_g, cfg)
    before = ck.LAUNCHES["chai_fused_decode"]
    for _ in range(3):
        lc, sc = chai(params_cpu, {"tokens": nxt}, sc, ctx)
        lg, sg = chai(params_gpu, {"tokens": nxt.cuda()}, sg, ctx_g)
        hold(lg, lc)
        nxt = lc.argmax(-1)
    launched = ck.LAUNCHES["chai_fused_decode"] - before
    if launched != 3 * cfg.n_global_layers:
        raise AssertionError(f"reduced STEADY launched {launched} kernels")
    log(f"reduced {cfg.name} (2 layers, fp32) cuda vs cpu: logits max abs "
        f"diff {worst:.3e} over prefill + 5 WARMUP + 3 STEADY steps")


def chai_applies(cfg):
    """CHAI runs on the config: it is enabled and has attention layers
    (rwkv6-1.6b has none, and its engines run with ``use_chai=False``)."""
    return cfg.chai.enabled and cfg.n_attn_layers > 0


def reduced_plain_check(cfg):
    """``reduced_reference_check`` for an arch without CHAI: the bucketed
    prefill (rows of 32, 19 and 5 real tokens in a bucket of 32) and 8
    plain decode steps, teacher-forced, the card against the CPU at 1e-4,
    every recurrent state leaf at 1e-4 after the last step; no kernel
    launched."""
    b, s = 3, 64
    params_cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params_gpu = {g: {n: t.cuda() for n, t in grp.items()}
                  for g, grp in params_cpu.items()}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, 32)))
    lens = torch.tensor([32, 19, 5])
    prefill = steps.make_serve_prefill(cfg, b, s)
    step = steps.make_serve_step(cfg, chai=False, decode_ts=PAGE)
    _reset_launches()
    lc, sc = prefill(params_cpu, {"tokens": toks, "true_lens": lens})
    lg, sg = prefill(params_gpu, {"tokens": toks.cuda(),
                                  "true_lens": lens.cuda()})
    worst = [float((lg.cpu() - lc).abs().max())]
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    nxt = lc.argmax(-1)
    for _ in range(8):
        lc, sc = step(params_cpu, {"tokens": nxt}, sc)
        lg, sg = step(params_gpu, {"tokens": nxt.cuda()}, sg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        worst.append(float((lg.cpu() - lc).abs().max()))
        nxt = lc.argmax(-1)
    for key in sc:
        torch.testing.assert_close(sg[key].cpu(), sc[key], atol=1e-4,
                                   rtol=1e-4)
    if any(_launches().values()):
        raise AssertionError(f"reduced {cfg.name}: kernels launched")
    log(f"reduced {cfg.name} (2 layers, fp32, no CHAI) cuda vs cpu: logits "
        f"max abs diff {max(worst):.3e} over a bucketed prefill + 8 decode "
        f"steps; state leaves {sorted(sc)} held at 1e-4; no launch")


# The launches by mode (``kernels.chai_attention.MODE_LAUNCHES``) of every
# run of the process that a _reset_launches() opens and a _launches()
# reads: one entry a run, filed at its first read.
MODE_RUNS = []
_RUN = {"open": False}


def _reset_launches():
    for counts in (ck.LAUNCHES, fk.LAUNCHES):
        for name in counts:
            counts[name] = 0
    ck.MODE_LAUNCHES.clear()
    _RUN["open"] = True


def _launches():
    """Every kernel's launch count since the last reset; the first read
    after a reset files the run's launches by mode in MODE_RUNS."""
    if _RUN["open"]:
        MODE_RUNS.append(dict(ck.MODE_LAUNCHES))
        _RUN["open"] = False
    return {**ck.LAUNCHES, **fk.LAUNCHES}


# Rows whose mode the wrapper cannot see: the relay's share shape is in
# its routing maps only, so its launches are not counted by mode.
MODE_BLIND = ("relay_prefix_decode[share]",)


def mode_launches(row, runs=None):
    """Launches of the kernel mode ``row`` ("<kernel>[<mode>+...]") over
    ``runs`` (default every filed run): every launch that ran at least
    that row's modes."""
    base, _, modes = row.partition("[")
    want = set(modes.rstrip("]").split("+"))
    return sum(n for run in (MODE_RUNS if runs is None else runs)
               for key, n in run.items()
               if key.partition("[")[0] == base
               and want <= set(key.partition("[")[2].rstrip("]").split("+")))


RG = "recurrentgemma-9b"         # 26 RG-LRU + 12 local MQA layers
RWKV = "rwkv6-1.6b"             # 24 RWKV layers, no attention
NEW_ARCHS = (GEMMA3, "deepseek-moe-16b", "qwen3-moe-30b-a3b",
             "internvl2-76b", "musicgen-large", RG, RWKV)


def reduced_embeddings_check(arch):
    """A frontend arch's float embeddings on the card against the CPU:
    ``forward_fullseq`` on (B, T, d) embeddings through the adapter, a
    prefill into a decode state, then ``decode_step`` with (B, d)
    embeddings, logits at 1e-4."""
    cfg, params_cpu, params_gpu = _reduced_model(arch)
    gen = torch.Generator().manual_seed(3)
    emb = torch.randn(2, 12, cfg.d_model, generator=gen)
    steps_emb = torch.randn(3, 2, cfg.d_model, generator=gen)
    worst = 0.0
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        lf, _ = tfm.forward_fullseq(params, cfg, emb.to(dev))
        st = tfm.init_decode_state(cfg, 2, 32, dev)
        lp, st = tfm.forward_fullseq(params, cfg, emb.to(dev), state=st,
                                     logits_slice="last")
        ld = []
        for e in steps_emb:
            lg, st = tfm.decode_step(params, cfg, None, st,
                                     embeddings=e.to(dev))
            ld.append(lg)
        out = [lf, lp] + ld
        if dev == "cpu":
            want = out
            continue
        for g, c in zip(out, want):
            torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=1e-4)
            worst = max(worst, float((g.cpu() - c).abs().max()))
    log(f"reduced {cfg.name} ({cfg.frontend} frontend) embeddings cuda vs "
        f"cpu: forward, prefill and 3 decode steps through the adapter, "
        f"logits max abs diff {worst:.3e}")


def reduced_arch_checks():
    """Phase 4 for the archs of ROADMAP #14 part B (gemma3-4b with
    qk_norm and local layers, the MoE archs, the frontend archs, and the
    recurrent archs: recurrentgemma-9b with an RG-LRU and a local layer,
    rwkv6-1.6b with two RWKV layers), reduced (2 layers, fp32) on the card
    against the CPU: the teacher-forced reference check (prefill, WARMUP,
    STEADY through the fused kernel on the global layers; rwkv: plain
    decode steps), the continuous engine paged and dense (rwkv without
    CHAI; neither recurrent arch has a global layer, so both run the
    unified layout and launch nothing), and for the frontend archs
    forward and decode on embeddings."""
    for arch in NEW_ARCHS:
        reduced_reference_check(arch)
        reduced_continuous_check(arch)
        if get_config(arch).frontend != "none":
            reduced_embeddings_check(arch)


def _reduced_model(arch=ARCH):
    cfg = reduced_cfg(arch)
    params_cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params_gpu = {g: {n: t.cuda() for n, t in grp.items()}
                  for g, grp in params_cpu.items()}
    return cfg, params_cpu, params_gpu


def _reduced_serve(cfg, params, device, prompts, budgets, identify=None,
                   stats=None, **ecfg):
    """Serve ``prompts`` on a 2-slot continuous engine; returns ({uid:
    tokens}, [(argmax input, live rows)], [(WARMUP buffer, membership)]).
    ``identify(sc, n)``: the n-th CLUSTER transition's membership in place
    of the engine's own; ``stats``: a dict given the engine's decode step
    count."""
    eng = ServingEngine(cfg, params, EngineConfig(batch_slots=2,
                                                  page_size=PAGE, **ecfg),
                        device=device)
    calls, idents = [], []
    argmax, own = eng._argmax, getattr(eng, "_identify", None)

    def rec_argmax(lg):
        live = ([True] * lg.shape[0]
                if lg.shape[0] == 1 or eng.ecfg.scheduler == "cohort" else
                [r is not None and eng._phases[i] != chai_cache.PHASE_PREFILL
                 for i, r in enumerate(eng._slot_req)])
        calls.append((lg.detach().cpu(), live))
        return argmax(lg)

    def rec_identify(sc):
        out = identify(sc, len(idents)) if identify else own(sc)
        idents.append((sc.cpu(), {k: v.cpu() for k, v in out.items()}))
        return out

    eng._argmax = rec_argmax
    if own is not None:
        eng._identify = rec_identify
    for i, (pr, m) in enumerate(zip(prompts, budgets)):
        eng.submit(pr, max_new_tokens=m, uid=i)
    done = {r.uid: r.generated for r in eng.run()}
    if [len(done[u]) for u in sorted(done)] != list(budgets):
        raise AssertionError(f"{device} {ecfg}: token counts wrong")
    if eng.paged and eng.dense_pool.pages_in_use:
        raise AssertionError(f"{device} {ecfg}: pages left in use")
    if stats is not None:
        stats["steps"] = eng.steps_executed
    return done, calls, idents


def _forced_identify(cpu_idents):
    """Cluster a cuda run through the cpu run's memberships, after holding
    its WARMUP buffer to the cpu one."""
    def forced(sc, n):
        want, ctx = cpu_idents[n]
        torch.testing.assert_close(sc.cpu(), want, atol=1e-5, rtol=1e-4)
        return {k: v.cuda() for k, v in ctx.items()}
    return forced


def _hold_calls(gpu_calls, cpu_calls, label):
    """Logits of every live row at 1e-4, call by call, until the first
    greedy token that differs, which must sit on a cpu top-2 margin <=
    1e-3. Returns (calls held, logits max abs diff)."""
    worst, held = 0.0, 0
    for (lg, live), (lc, _) in zip(gpu_calls, cpu_calls):
        rows = [i for i, a in enumerate(live) if a]
        g, c = lg[rows], lc[rows]
        differ = g.argmax(-1) != c.argmax(-1)
        if differ.any():
            top2 = c.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1])[differ]
            if (margin > 1e-3).any():
                raise AssertionError(f"{label}: cuda token differs at "
                                     f"margin {margin.tolist()}")
            log(f"{label}: tokens part at a near-tie (margin "
                f"{margin.tolist()}) after {held} held steps")
            break
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((g - c).abs().max()))
        held += 1
    return held, worst


def reduced_continuous_check(arch=ARCH):
    """The continuous engine on the reduced model: cpu (plain versions)
    against cuda (the kernels), paged and dense. The cuda runs cluster
    through the cpu run's membership (after holding their WARMUP buffers
    to it), so the two devices decode the same clustered attention;
    logits of every live row are held at 1e-4 until the first greedy
    token that differs, which must sit on a cpu top-2 margin <= 1e-3.
    The two cuda layouts must give identical tokens. An arch without
    CHAI (``chai_applies``) serves with ``use_chai=False``; an arch
    without a global layer launches no kernel."""
    cfg, params_cpu, params_gpu = _reduced_model(arch)
    chai = chai_applies(cfg)
    rng = np.random.default_rng(1)
    budgets = (12, 7, 10, 4, 9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (11, 6, 17, 9, 14)]
    cpu_done, cpu_calls, cpu_idents = _reduced_serve(
        cfg, params_cpu, "cpu", prompts, budgets, max_seq=64, use_chai=chai)
    gpu = {}
    for layout in ("paged", "dense"):
        _reset_launches()
        gpu[layout] = _reduced_serve(
            cfg, params_gpu, "cuda", prompts, budgets,
            _forced_identify(cpu_idents), max_seq=64, kv_layout=layout,
            use_chai=chai)
        launched = _launches()
        own, other = (("paged_chai_fused_decode", "chai_fused_decode")
                      if layout == "paged" else
                      ("chai_fused_decode", "paged_chai_fused_decode"))
        if not cfg.n_global_layers:
            if any(launched.values()):
                raise AssertionError(f"reduced continuous {layout}: "
                                     f"launches {launched} without a "
                                     "global layer")
        elif (not launched[own] or launched[other]
                or launched["flash_prefill"]
                or launched["paged_prefix_attend"]):
            raise AssertionError(f"reduced continuous {layout}: launches "
                                 f"{launched}")
    if gpu["paged"][0] != gpu["dense"][0]:
        raise AssertionError("reduced continuous: paged and dense layouts "
                             "gave different tokens on the card")
    held, worst = _hold_calls(gpu["paged"][1], cpu_calls,
                              "reduced continuous")
    log(f"reduced {cfg.name} continuous engine cuda vs cpu: {held} of "
        f"{len(cpu_calls)} argmax calls held, logits max abs diff "
        f"{worst:.3e}; tokens paged == dense on the card; cpu == cuda "
        f"tokens: {cpu_done == gpu['paged'][0]}")


def reduced_mha_check(arch=ARCH):
    """The MHA baseline (``use_chai=False``) on the reduced model, cuda
    (the flash decode kernels) against cpu (their plain versions): the
    continuous engine paged and dense and the cohort engine; logits held
    at 1e-4 until a near-tie; ``paged_decode`` (paged) or
    ``flash_decode`` launched n_layers times per decode step, no other
    kernel, and the eager decode attention never; paged == dense tokens
    on the card."""
    cfg, params_cpu, params_gpu = _reduced_model(arch)
    rng = np.random.default_rng(4)
    budgets = (12, 7, 10, 4, 9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (11, 6, 17, 9, 14)]
    tokens = {}
    for name, kw in (("paged", dict(kv_layout="paged")),
                     ("dense", dict(kv_layout="dense")),
                     ("cohort", dict(scheduler="cohort"))):
        kw = dict(kw, max_seq=64, use_chai=False)
        _, cpu_calls, _ = _reduced_serve(cfg, params_cpu, "cpu", prompts,
                                         budgets, **kw)
        _reset_launches()
        EAGER["calls"] = 0
        stats = {}
        tokens[name], gpu_calls, _ = _reduced_serve(
            cfg, params_gpu, "cuda", prompts, budgets, stats=stats, **kw)
        launched = _launches()
        own = "paged_decode" if name == "paged" else "flash_decode"
        want = {k: 0 for k in launched}
        want[own] = cfg.n_layers * stats["steps"]
        if launched != want or EAGER["calls"]:
            raise AssertionError(f"reduced MHA {name}: launches {launched}, "
                                 f"expected {want}; eager decode calls "
                                 f"{EAGER['calls']}")
        held, worst = _hold_calls(gpu_calls, cpu_calls,
                                  f"reduced MHA {name}")
        log(f"reduced {cfg.name} MHA baseline ({name}) cuda vs cpu: "
            f"{held} of {len(cpu_calls)} argmax calls held, logits max abs "
            f"diff {worst:.3e}, launches {want[own]} of {own}")
    if tokens["paged"] != tokens["dense"]:
        raise AssertionError("reduced MHA: paged and dense tokens differ on "
                             "the card")


def reduced_chunked_check():
    """The chunked continuous engine (chunks of 16 tokens, max_seq 128) on
    the reduced model, cuda against cpu as in ``reduced_continuous_check``:
    5 prompts of 40/9/33/20/50 tokens take 3 + 3 + 2 + 4 = 12 chunks, so
    each prefill kernel launches 12 x 2 layers times; logits held at 1e-4
    until a near-tie."""
    cfg, params_cpu, params_gpu = _reduced_model()
    rng = np.random.default_rng(2)
    lens, budgets = (40, 9, 33, 20, 50), (10, 6, 8, 5, 7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    kw = dict(max_seq=128, prefill_chunk_tokens=16)
    cpu_done, cpu_calls, cpu_idents = _reduced_serve(
        cfg, params_cpu, "cpu", prompts, budgets, **kw)
    _reset_launches()
    gpu_done, gpu_calls, _ = _reduced_serve(
        cfg, params_gpu, "cuda", prompts, budgets,
        _forced_identify(cpu_idents), **kw)
    launched = _launches()
    n_chunks = sum(-(-n // 16) for n in lens if n > 16)
    if (launched["flash_prefill"] != n_chunks * cfg.n_layers
            or launched["paged_prefix_attend"] != n_chunks * cfg.n_layers
            or not launched["paged_chai_fused_decode"]):
        raise AssertionError(f"reduced chunked: launches {launched}, "
                             f"{n_chunks} chunks")
    held, worst = _hold_calls(gpu_calls, cpu_calls, "reduced chunked")
    mono, _, _ = _reduced_serve(cfg, params_gpu, "cuda", prompts, budgets,
                                max_seq=128)
    log(f"reduced chunked engine cuda vs cpu: {n_chunks} chunks, launches "
        f"{launched}; {held} of {len(cpu_calls)} argmax calls held, logits "
        f"max abs diff {worst:.3e}; cpu == cuda tokens: "
        f"{cpu_done == gpu_done}; information only: chunked == monolithic "
        f"tokens on the card: {gpu_done == mono}")


def _prefix_traffic(rng, vocab, prefix_len, suffix_lens, suffix_new,
                    replay_new):
    """(warm request, the rest) as (uid, prompt, max_new): a shared prompt
    warmed by a request of 4 tokens (it retires in WARMUP), requests of
    the prompt plus a private suffix, then the first of them again (a
    snapshot hit) and once more with ``replay_new`` tokens (a replay)."""
    prefix = rng.integers(0, vocab, size=prefix_len).tolist()
    warm = (0, prefix + [int(rng.integers(0, vocab))], 4)
    rest = [(i + 1, prefix + rng.integers(0, vocab, size=n).tolist(), m)
            for i, (n, m) in enumerate(zip(suffix_lens, suffix_new))]
    first = rest[0][1]
    rest += [(len(rest) + 1, first, suffix_new[0]),
             (len(rest) + 2, first, replay_new)]
    return warm, rest


def _expected_hits(warm, rest, prefix_len, snapshots=True):
    """{uid: (cache_hit, cached_tokens, prefill_tokens)} of that traffic.
    Without CHAI snapshots (a GQA model), the repeated prompt is a
    ``"prefix"`` hit on every block of it the first request's prefill
    indexed, but the last token's."""
    hits = {warm[0]: ("", 0, len(warm[1]))}
    for uid, prompt, _ in rest[:-2]:
        hits[uid] = ("prefix", prefix_len, len(prompt) - prefix_len)
    for (uid, prompt, _), kind in zip(rest[-2:], ("snapshot", "replay")):
        cached = (len(prompt) - 1) // PAGE * PAGE
        hits[uid] = ((kind, len(prompt), 0) if snapshots else
                     ("prefix", cached, len(prompt) - cached))
    return hits


def reduced_prefix_relay_check(arch=ARCH):
    """The continuous engine with ``prefix_cache=True, relay_decode=True``
    on the reduced model (2 slots, max_seq 64), cuda against cpu: a
    32-token prompt warmed by one request, three suffix requests (the
    first two decode as a relay group of 2), a snapshot hit and a replay
    (a GQA model: two more prefix hits). The cuda run clusters through the
    cpu run's memberships; logits held at 1e-4 until a near-tie; the plan
    kinds as expected on both; exactly 2 x relay steps launches of
    ``relay_prefix_decode`` and 2 x each suffix prefill of each prefill
    kernel; the pools empty after a clear."""
    cfg, params_cpu, params_gpu = _reduced_model(arch)
    warm, rest = _prefix_traffic(np.random.default_rng(3), cfg.vocab_size,
                                 32, (4, 6, 5), (10, 12, 10),
                                 cfg.chai.warmup_tokens + 1)
    want_hits = _expected_hits(warm, rest, 32, snapshots=cfg.is_mha)
    runs = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = ServingEngine(cfg, params, EngineConfig(
            batch_slots=2, max_seq=64, page_size=PAGE, num_pages=33,
            num_chai_pages=25, prefix_cache=True, relay_decode=True),
            device=device)
        calls, idents = [], []
        argmax, own = eng._argmax, eng._identify
        forced = (None if device == "cpu"
                  else _forced_identify(runs["cpu"]["idents"]))

        def rec_argmax(lg, eng=eng, calls=calls, argmax=argmax):
            live = ([True] if lg.shape[0] == 1 else
                    [r is not None
                     and eng._phases[i] != chai_cache.PHASE_PREFILL
                     for i, r in enumerate(eng._slot_req)])
            calls.append((lg.detach().cpu(), live))
            return argmax(lg)

        def rec_identify(sc, idents=idents, own=own, forced=forced):
            out = forced(sc, len(idents)) if forced else own(sc)
            idents.append((sc.cpu(), {k: v.cpu() for k, v in out.items()}))
            return out

        eng._argmax, eng._identify = rec_argmax, rec_identify
        _reset_launches()
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
        eng.run()
        for uid, prompt, m in rest:
            eng.submit(prompt, max_new_tokens=m, uid=uid)
        done = {r.uid: r for r in eng.run()}
        launched = _launches()
        hits = {u: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
                for u, r in done.items()}
        if hits != want_hits or not eng.relay_steps:
            raise AssertionError(f"reduced prefix/relay {device}: hits "
                                 f"{hits}, relay steps {eng.relay_steps}")
        eng.prefix_cache.clear()
        if eng.dense_pool.pages_in_use or (eng.chai_pool is not None
                                           and eng.chai_pool.pages_in_use):
            raise AssertionError(f"reduced prefix/relay {device}: pages "
                                 "left in use after clear()")
        runs[device] = dict(tokens={u: r.generated for u, r in done.items()},
                            calls=calls, idents=idents,
                            relay_steps=eng.relay_steps, launched=launched)
    gpu = runs["cuda"]
    n_suffix = len(rest) - (2 if cfg.is_mha else 0)
    if (gpu["launched"]["relay_prefix_decode"]
            != cfg.n_layers * gpu["relay_steps"]
            or gpu["launched"]["flash_prefill"] != cfg.n_layers * n_suffix
            or gpu["launched"]["paged_prefix_attend"]
            != cfg.n_layers * n_suffix
            or not gpu["launched"]["paged_chai_fused_decode"]):
        raise AssertionError(f"reduced prefix/relay: launches "
                             f"{gpu['launched']}, relay steps "
                             f"{gpu['relay_steps']}")
    held, worst = _hold_calls(gpu["calls"], runs["cpu"]["calls"],
                              "reduced prefix/relay")
    log(f"reduced {cfg.name} prefix cache + relay engine cuda vs cpu: "
        f"relay steps {gpu['relay_steps']} (cpu "
        f"{runs['cpu']['relay_steps']}), launches"
        f" {gpu['launched']}; {held} of {len(runs['cpu']['calls'])} argmax "
        f"calls held, logits max abs diff {worst:.3e}; plan kinds "
        f"{want_hits}; cpu == cuda tokens: "
        f"{runs['cpu']['tokens'] == gpu['tokens']}")


# ------------------------------------------------------------ phase 5 ----
class _Capture:
    """Stands in for ``kernels.ops`` inside ``core.chai_attention`` and
    keeps a copy of a decode op's inputs (layer 0 of the step) the first
    time ``when()`` names a step kind, under (op, kind), with the value
    ``note()`` gives; every call goes on to the real dispatch. ``modes``
    counts the calls by (op, share_values), ``caps`` by (op, softcap),
    ``dtypes`` by (op, K dtype)."""

    def __init__(self, when=lambda: "first", note=lambda: None):
        self.first, self.modes, self.caps, self.dtypes = {}, {}, {}, {}
        self.when, self.note = when, note

    def _keep(self, op, tensors, kw):
        mode = (op, bool(kw.get("share_values")))
        self.modes[mode] = self.modes.get(mode, 0) + 1
        cap = (op, float(kw.get("softcap", 0.0)))
        self.caps[cap] = self.caps.get(cap, 0) + 1
        k = tensors.get("k", tensors.get("k_pool"))
        dt = (op, str(k.dtype).replace("torch.", ""))
        self.dtypes[dt] = self.dtypes.get(dt, 0) + 1
        kind = self.when()
        if kind is not None and (op, kind) not in self.first:
            self.first[op, kind] = dict(
                {k: t.clone() for k, t in tensors.items()},
                kw={k: v.clone() if torch.is_tensor(v) else v
                    for k, v in kw.items()}, note=self.note())

    def chai_decode_attention(self, q_rep, k, v, h2c, pos, **kw):
        self._keep("dense", dict(q=q_rep, k=k, v=v, h2c=h2c, pos=pos), kw)
        return kops.chai_decode_attention(q_rep, k, v, h2c, pos, **kw)

    def paged_chai_decode_attention(self, q_rep, k_pool, bt_k, v_pool, bt_v,
                                    h2c, pos, **kw):
        self._keep("paged", dict(q=q_rep, k_pool=k_pool, bt_k=bt_k,
                                 v_pool=v_pool, bt_v=bt_v, h2c=h2c, pos=pos),
                   kw)
        return kops.paged_chai_decode_attention(q_rep, k_pool, bt_k, v_pool,
                                                bt_v, h2c, pos, **kw)

    def relay_prefix_attention(self, q, k, v, k_row, a_row, v_row, plen,
                               **kw):
        self._keep("relay", dict(q=q, k=k, v=v, k_row=k_row, a_row=a_row,
                                 v_row=v_row, plen=plen), kw)
        return kops.relay_prefix_attention(q, k, v, k_row, a_row, v_row,
                                           plen, **kw)

    merge_decode_states = staticmethod(kops.merge_decode_states)
    finalize_decode_state = staticmethod(kops.finalize_decode_state)


def _timed(fn, phase, acc, calls=None):
    """``fn`` with its device time added to ``acc[phase]`` (host clock
    between two synchronizations; the engine synchronizes after every
    step anyway, when it reads the sampled tokens) and its calls counted
    in ``calls[phase]``."""
    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[phase] = acc.get(phase, 0.0) + time.perf_counter() - t0
        if calls is not None:
            calls[phase] = calls.get(phase, 0) + 1
        return out
    return wrapped


def _check_logits(eng, vocab):
    argmax = eng._argmax

    def checked_argmax(logits):
        if logits.shape[-1] != vocab or not torch.isfinite(logits).all():
            raise AssertionError("non-finite or misshapen logits")
        return argmax(logits)
    eng._argmax = checked_argmax


def serve(cfg, params, use_chai, prompts=PROMPT_LENS, max_seq=MAX_SEQ,
          hook=None):
    """Serve the cohort path's requests (``prompts``: their lengths, each
    with MAX_NEW new tokens; ``hook(engine)`` runs before they are
    submitted); returns (engine, requests sorted by uid, wall seconds,
    {phase: seconds})."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=max_seq, scheduler="cohort",
        use_chai=use_chai, page_size=PAGE))
    phases = {}
    for attr, phase in (("_prefill", "prefill"), ("_mha_step", "mha_decode"),
                        ("_identify", "cluster"), ("_compact", "compact"),
                        ("_chai_step", "chai_decode")):
        if hasattr(eng, attr):
            setattr(eng, attr, _timed(getattr(eng, attr), phase, phases))
    _check_logits(eng, cfg.vocab_size)
    if hook is not None:
        hook(eng)
    rng = np.random.default_rng(0)
    for i, n in enumerate(prompts):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n),
                   max_new_tokens=MAX_NEW, uid=i)
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    return eng, sorted(done, key=lambda r: r.uid), time.time() - t0, phases


def init_full_model(arch=ARCH, n_layers=None):
    """The arch's seeded weights on the card at full width; with
    ``n_layers``, made at the cut config directly (``cut_config``): the
    weights of a model larger than the card (internvl2-76b, 141 GB in
    bf16), or whose fp32 staging of a leaf would not fit beside the rest
    (qwen3-moe-30b-a3b's expert stacks), are never made whole."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cut_config(cfg, n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for grp in params.values() for t in grp.values())
    log(f"{cfg.name}: {n_params / 1e9:.3f} B params in {cfg.dtype} "
        f"({n_params * 2 / 1e9:.2f} GB), init {time.time() - t0:.1f} s, "
        f"device memory peak during init "
        f"{torch.cuda.max_memory_allocated():,} B, allocated after "
        f"{torch.cuda.memory_allocated():,} B")
    return cfg, params


def side_konly(cfg, params):
    """Phase 6's traffic on the first SIDE_DEPTH layers, paged then
    dense: the K-only CHAI runs that phases 11 and 12's cut runs are held
    against. Returns {layout: _run_summary}."""
    out = {}
    for layout in ("paged", "dense"):
        run = serve_continuous(cfg, params, layout)
        _check_served(cfg, run, f"side_continuous_{layout}")
        out[layout] = _run_summary(run)
        log(f"side K-only run, {cfg.n_layers} layers, {layout}: "
            f"{out[layout]['tok_s']:.1f} tok/s, launches {run['launches']}")
        run.clear()
        torch.cuda.empty_cache()
    return out


def cut_config(cfg, n=SIDE_DEPTH):
    """The first ``n`` layers of ``cfg``, every width kept; the cluster
    counts, where the config gives them, those of its first attention
    layers."""
    cut = cfg.replace(n_layers=n, layer_types=cfg.layer_types[:n],
                      ffn_types=cfg.ffn_types[:n])
    return cut.with_chai(
        cluster_counts=tuple(cfg.chai.cluster_counts[:cut.n_attn_layers]))


def cut_depth(cfg, params, n=SIDE_DEPTH):
    """The first ``n`` layers of ``cfg`` and ``params``: each stacked
    group is sliced (views) to its own family's layers among the first
    ``n`` (the layer plan's counters: ``attn`` over the attention layers,
    the dense ``ffn`` group over the dense-FFN layers, ``moe`` over the
    MoE layers), every width is kept."""
    cut = cut_config(cfg, n)
    keep = {"attn": cut.n_attn_layers, "ffn": cut.n_dense_ffn,
            "moe": cut.n_moe_ffn}
    return cut, {g: ({k: w[:keep[g]] for k, w in grp.items()}
                     if g in keep else grp)
                 for g, grp in params.items()}


def main_path(cfg, params):
    """The cohort path (phase 5)."""
    cap = _Capture()
    chai_core.kops = cap
    try:
        _reset_launches()
        EAGER["calls"] = 0
        eng, done, wall, phases = serve(cfg, params, use_chai=True)
        launches = _launches()
        chai_eager = EAGER["calls"]
    finally:
        chai_core.kops = kops
    n_tok = sum(len(r.generated) for r in done)
    counts = [len(r.generated) for r in done]
    if counts != [MAX_NEW] * len(PROMPT_LENS):
        raise AssertionError(f"token counts {counts}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of vocabulary")
    steady = MAX_NEW - 1 - cfg.chai.warmup_tokens
    want = {name: 0 for name in launches}
    want["chai_fused_decode"] = steady * cfg.n_layers
    if launches != want:
        raise AssertionError(f"cohort path launches {launches}, expected "
                             f"{want}")
    kc, km = eng.kv_bytes(chai=True), eng.kv_bytes(chai=False)
    log(f"cohort: served {len(done)} requests (prompts {PROMPT_LENS}, "
        f"{MAX_NEW} new tokens each) in {wall:.3f} s: {n_tok / wall:.1f} "
        f"tok/s, TTFT {[round(r.ttft, 4) for r in done]} s, decode steps "
        f"{eng.steps_executed}, launches {launches} (none of flash_decode "
        f"or paged_decode: WARMUP keeps the eager attention, {chai_eager} "
        "calls)")
    log("cohort CHAI run by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items()))
    log(f"KV bytes at capacity: CHAI {kc:,} vs MHA {km:,} "
        f"(saving {100 * (1 - kc / km):.2f}%)")

    first = cap.first["dense", "first"]
    rpg = first["kw"].get("reps_per_group", 1)
    err, ms, plain_ms = fused_decode_case(
        first["q"], first["k"], first["v"], first["h2c"], first["pos"],
        rpg=rpg, ts=first["kw"]["ts"])
    bound, by = fused_decode_bound(first["q"], first["k"], first["v"],
                                   first["h2c"], first["pos"], rpg)
    dense_call = (lambda: ck.chai_fused_decode(
        first["q"], first["k"], first["v"], first["h2c"], first["pos"],
        reps_per_group=rpg, ts=first["kw"]["ts"]))
    single = single_call_ms(dense_call)
    dev_ms = device_ms(dense_call, "chai_fused_decode_kernel")
    log(f"cohort layer 0, first STEADY step: q {tuple(first['q'].shape)}"
        f" {first['q'].dtype}, k {tuple(first['k'].shape)} "
        f"{first['k'].dtype}, pos {first['pos'].tolist()}: max_abs_err "
        f"{err:.3e}, kernel {ms:.4f} ms (single call {single:.4f} ms, "
        f"profiled device time {dev_ms} ms), "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")

    # The MHA baseline on the same requests: every decode step of every
    # layer through flash_decode (the cohort's dense cache, tile = page),
    # never through the eager attention the CHAI run's WARMUP keeps.
    _reset_launches()
    EAGER["calls"] = 0
    mha_eng, mha_done, mha_wall, mha_phases = serve(cfg, params,
                                                    use_chai=False)
    mha_launches = _launches()
    want = {name: 0 for name in mha_launches}
    want["flash_decode"] = cfg.n_layers * mha_eng.steps_executed
    if mha_launches != want or EAGER["calls"]:
        raise AssertionError(f"cohort MHA launches {mha_launches}, expected "
                             f"{want}; eager decode calls {EAGER['calls']}")
    agree = sum(a == b for r, m in zip(done, mha_done)
                for a, b in zip(r.generated, m.generated))
    log(f"cohort MHA baseline: {mha_eng.steps_executed} decode steps, "
        f"launches {want['flash_decode']} of flash_decode, 0 eager decode "
        f"attention calls; {n_tok / mha_wall:.1f} tok/s in {mha_wall:.3f} s "
        f"(CHAI run {n_tok / wall:.1f} tok/s in {wall:.3f} s); by phase "
        + ", ".join(f"{k} {v:.4f}" for k, v in mha_phases.items())
        + f"; information only (random weights): CHAI vs MHA greedy token "
        f"agreement {agree}/{n_tok}")
    main = dict(case="main_path_layer0", q=list(first["q"].shape),
                k=list(first["k"].shape), v=list(first["v"].shape),
                dtype=str(first["k"].dtype), ts=first["kw"]["ts"],
                pos=first["pos"].tolist(), max_abs_err=err, ms=ms,
                single_call_ms=single, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
    return launches, main, first, mha_launches


# ------------------------------------------------------------ phase 6 ----
class _TransformerCapture:
    """Stands in for ``kernels.ops`` inside ``models.transformer`` and keeps
    a copy of each prefill op's inputs the first time ``when()`` names a
    chunk start (layer 0 of that chunk), and of each flash decode op's
    (the MHA baseline's) the first time it names an occupancy; every call
    goes on to the real dispatch."""

    def __init__(self, when):
        self.first = {}
        self.when = when

    def _keep(self, op, tensors):
        key = (op, self.when())
        if key not in self.first:
            self.first[key] = {k: t.clone() for k, t in tensors.items()}

    def paged_prefix_attention(self, q, kv_pool, bt_k, bt_v, plen, **kw):
        self._keep("paged_prefix_attend", dict(
            q=q, pool=kv_pool, bt_k=bt_k, bt_v=bt_v, plen=plen,
            **{k: v for k, v in kw.items() if torch.is_tensor(v)}))
        return kops.paged_prefix_attention(q, kv_pool, bt_k, bt_v, plen,
                                           **kw)

    def flash_prefill_attention(self, q, k, v, offset=0, **kw):
        self._keep("flash_prefill", dict(q=q, k=k, v=v))
        return kops.flash_prefill_attention(q, k, v, offset, **kw)

    def flash_decode_attention(self, q, k, v, pos, **kw):
        self._keep("flash_decode", dict(q=q, k=k, v=v, pos=pos,
                                        ts=torch.tensor(kw.get("ts", 0))))
        return kops.flash_decode_attention(q, k, v, pos, **kw)

    def paged_decode_attention(self, q, kv_pool, bt_k, bt_v, pos, **kw):
        self._keep("paged_decode", dict(q=q, pool=kv_pool, bt_k=bt_k,
                                        bt_v=bt_v, pos=pos))
        return kops.paged_decode_attention(q, kv_pool, bt_k, bt_v, pos, **kw)

    merge_prefill_states = staticmethod(kops.merge_prefill_states)
    finalize_prefill_state = staticmethod(kops.finalize_prefill_state)


def _record_margins(eng):
    """Wrap the engine's argmax: {uid: [top-2 logit margin behind each of
    its greedy tokens]} (the first from the prefill's batch-1 logits,
    then one row per decode step)."""
    margins, prefilling = {}, []
    argmax, finish = eng._argmax, eng._finish_prefill

    def finish_prefill(i, req, logits):
        prefilling.append(req.uid)
        try:
            return finish(i, req, logits)
        finally:
            prefilling.pop()

    def rec_argmax(logits):
        top2 = logits.float().topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        uids = (prefilling[-1:] if prefilling else
                [r.uid if r is not None
                 and eng._phases[i] != chai_cache.PHASE_PREFILL else None
                 for i, r in enumerate(eng._slot_req)])
        for uid, gap in zip(uids, gaps):
            if uid is not None:
                margins.setdefault(uid, []).append(gap)
        return argmax(logits)

    eng._argmax, eng._finish_prefill = rec_argmax, finish_prefill
    return margins


def serve_continuous(cfg, params, layout, chunk=0, membership=None,
                     use_chai=True, traffic=(CONT_PROMPT_LENS, CONT_MAX_NEW),
                     max_seq=MAX_SEQ, faults=None, **ecfg_kw):
    """Serve the continuous path's requests on one KV layout (``chunk``:
    with chunked prefill), with the launches counted over the run, each
    step kind and each ``step()`` timed, the KV bytes read around every
    CLUSTER transition, the decode ops' layer-0 inputs kept at the first
    all-STEADY and mixed steps, the prefill ops' at the first chunk of
    each start position, the top-2 margin behind every greedy token and
    each request's WARMUP buffer and membership. ``membership`` ({uid:
    (buffer, ctx, _)}, another run's): cluster each request it names
    through it, noting whether its own membership was the same. ``use_chai=False``:
    the MHA baseline, every decode step an "mha_step", the flash decode
    ops' layer-0 inputs kept at the first step of each occupancy.
    ``traffic``: (prompt lengths, new tokens) of the requests. ``faults``:
    the engine's ``FaultInjector`` (its degraded steps timed as
    "degraded_<kind>"); ``ecfg_kw``: more ``EngineConfig`` settings. Each
    ``step()`` is recorded in ``per_step`` (its
    ``paged_chai_fused_decode`` launches, whether it decoded and ran
    degraded, its kernel-path CHAI steps)."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=max_seq, page_size=PAGE,
        kv_layout=layout, prefill_chunk_tokens=chunk, use_chai=use_chai,
        **ecfg_kw), faults=faults)
    times, calls = {}, {}
    for attr, phase in (("_slot_prefill", "prefill"),
                        ("_chunk_prefill", "chunk"),
                        ("_mha_step",
                         "warmup_step" if use_chai else "mha_step"),
                        ("_mixed_step", "mixed_step"),
                        ("_chai_step", "steady_step")):
        if hasattr(eng, attr):
            setattr(eng, attr, _timed(getattr(eng, attr), phase, times,
                                      calls))
    if faults is not None:
        plain = eng._plain_decode_steps()
        for key, phase in (("mha", "degraded_warmup_step"),
                           ("mixed", "degraded_mixed_step"),
                           ("chai", "degraded_steady_step")):
            if key in plain:
                plain[key] = _timed(plain[key], phase, times, calls)
    idents, own = {}, getattr(eng, "_identify", None)

    def identify(sc):
        i = int(np.flatnonzero(eng._phases == chai_cache.PHASE_CLUSTER)[0])
        uid = eng._slot_req[i].uid
        out = own(sc)        # run either way: both runs pay for K-Means
        if membership is not None and uid in membership:
            forced = membership[uid][1]
            same = all(torch.equal(out[k], forced[k]) for k in out)
            out = forced
        else:
            same = True
        idents[uid] = (sc.clone(), out, same)
        return out
    transitions = []
    if use_chai:
        eng._identify = identify
        cluster = eng._cluster_fn()

        def watched_cluster(*args):
            before = eng.kv_bytes()
            pages = eng._slot_pages[int(args[2])] if eng.paged else {}
            n_dense = len(pages.get("kg", ())) + len(pages.get("vg", ()))
            out = cluster(*args)
            transitions.append((before, len(eng.kv_bytes_history), n_dense))
            return out
        eng._cluster_slot = _timed(watched_cluster, "cluster", times, calls)
    _check_logits(eng, cfg.vocab_size)
    margins = _record_margins(eng)
    chunk_start = [None]
    if chunk:
        chunk_fn = eng._chunk_prefill

        def noted_chunk(*args):
            chunk_start[0] = args[3]          # prefix_len: the chunk start
            return chunk_fn(*args)
        eng._chunk_prefill = noted_chunk
    step, step_s, per_step = eng.step, [], []
    in_flight = {"mixed": 0, "no_decode": 0}

    def timed_step():
        mixed0 = calls.get("mixed_step", 0)
        chai0 = mixed0 + calls.get("steady_step", 0)
        n0, fb0 = eng.steps_executed, eng.decode_fallbacks
        degraded0 = eng.degraded_decode
        fused0 = ck.LAUNCHES["paged_chai_fused_decode"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(dict(
            fused=ck.LAUNCHES["paged_chai_fused_decode"] - fused0,
            decoded=eng.steps_executed > n0,
            degraded=degraded0 or eng.decode_fallbacks > fb0,
            chai_steps=calls.get("mixed_step", 0)
            + calls.get("steady_step", 0) - chai0))
        if any(st is not None for st in eng._slot_prefill_state):
            in_flight["mixed"] += calls.get("mixed_step", 0) > mixed0
            in_flight["no_decode"] += eng.steps_executed == n0
        return out
    eng.step = timed_step

    def step_kind():
        """"steady" when every occupied slot is STEADY, else "mixed" (the
        decode ops run only in these two kinds of step)."""
        occupied = eng._phases[eng._phases != chai_cache.PHASE_FREE]
        return ("steady" if (occupied == chai_cache.PHASE_STEADY).all()
                else "mixed")
    cap = _Capture(step_kind, lambda: torch.from_numpy(
        eng._phases.copy()).cuda())
    pcap = _TransformerCapture(
        (lambda: chunk_start[0]) if use_chai else
        (lambda: int((eng._phases != chai_cache.PHASE_FREE).sum())))
    rng = np.random.default_rng(0)
    for i, (n, m) in enumerate(zip(*traffic)):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n),
                   max_new_tokens=m, uid=i)
    chai_core.kops, tfm.kops = cap, pcap
    try:
        start = _memory_start()
        _reset_launches()
        t0 = time.time()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launches()
    finally:
        chai_core.kops, tfm.kops = kops, kops
    return dict(eng=eng, done=sorted(done, key=lambda r: r.uid), wall=wall,
                times=times, calls=calls, transitions=transitions,
                launches=launches, capture=cap.first, modes=cap.modes,
                caps=cap.caps, dtypes=cap.dtypes, traffic=traffic,
                prefill=pcap.first, margins=margins, idents=idents,
                step_s=step_s, per_step=per_step,
                in_flight=in_flight, kv_history=eng.kv_bytes_history,
                device_start=start,
                device_peak=torch.cuda.max_memory_allocated())


def _memory_start():
    """Collect the engines of earlier runs (they sit in reference cycles
    through their wrapped hooks), reset the peak, and return the device
    memory allocated now: a run's peak above it is its own (pools,
    activations)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _check_served(cfg, run, label):
    """Token counts, vocabulary, and both CHAI step kinds ran (an MHA
    baseline run: only baseline steps)."""
    done, calls = run["done"], run["calls"]
    counts = [len(r.generated) for r in done]
    if (counts != list(run["traffic"][1])
            or any(r.finish_reason != FINISH_LENGTH for r in done)):
        raise AssertionError(f"{label}: token counts {counts}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of vocabulary")
    if "mha_step" in calls:
        if set(calls) - {"prefill", "mha_step"}:
            raise AssertionError(f"{label}: step kinds {calls}")
    elif not (calls.get("mixed_step") and calls.get("steady_step")):
        raise AssertionError(f"{label}: step kinds {calls}")
    if [len(run["margins"][r.uid]) for r in done] != counts:
        raise AssertionError(f"{label}: margins not recorded per token")
    _check_modes(cfg, run, label)


def _check_modes(cfg, run, label):
    """Every fused decode call of a CHAI run in the config's mode
    (share_values or not); the relay op has no such flag."""
    share = cfg.chai.share_values
    if any(flag != share for (op, flag) in run["modes"] if op != "relay"):
        raise AssertionError(f"{label}: decode calls by (op, share_values) "
                             f"{run['modes']}, expected share_values={share}")


def _log_served(run, label):
    eng, done, calls = run["eng"], run["done"], run["calls"]
    n_tok = sum(len(r.generated) for r in done)
    per_call = {k: 1e3 * run["times"][k] / calls[k] for k in calls}
    log(f"{label}: served {len(done)} requests (prompts {run['traffic'][0]}, "
        f"new {run['traffic'][1]}) in {run['wall']:.3f} s: "
        f"{n_tok / run['wall']:.1f} tok/s, TTFT "
        f"{[round(r.ttft, 4) for r in done]} s (mean "
        f"{statistics.mean(r.ttft for r in done):.4f}), decode steps "
        f"{eng.steps_executed} {calls}, launches {run['launches']}")
    log(f"{label} by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in run["times"].items())
        + "; ms per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in per_call.items())
        + f"; engine steps {len(run['step_s'])}, longest "
        f"{1e3 * max(run['step_s']):.2f} ms; device memory peak "
        f"{run['device_peak']:,} B, {run['device_peak'] - run['device_start']:,}"
        " B above the run's start")


def _check_kv_bytes(run, label):
    """The allocated KV bytes fall at every CLUSTER transition, and both
    pools are empty at the end."""
    eng = run["eng"]
    hist = eng.kv_bytes_history
    falls = [(before, hist[idx]["kv_bytes"])
             for before, idx, _ in run["transitions"]]
    if (len(falls) != len(run["traffic"][0])
            or not all(after < before for before, after in falls)):
        raise AssertionError(f"{label}: KV bytes around CLUSTER: {falls}")
    if eng.dense_pool.pages_in_use or eng.chai_pool.pages_in_use:
        raise AssertionError(f"{label}: pools not empty after the run")
    log(f"{label} KV bytes (before -> after) at each CLUSTER transition: "
        f"{falls}; peak {eng.kv_bytes_peak():,}, capacity "
        f"{eng.kv_bytes_capacity():,}, at the end {eng.kv_bytes():,}")


def continuous_path(cfg, params):
    """The continuous path on both layouts (phase 6); returns
    ({path: launches}, the paged kernel's main-path case at the first
    all-STEADY step, its case at the first mixed step, the paged run's
    tokens, margins and memberships for phase 7)."""
    runs = {}
    for layout in ("paged", "dense"):
        run = serve_continuous(cfg, params, layout)
        eng, calls = run["eng"], run["calls"]
        _check_served(cfg, run, layout)
        own = ("paged_chai_fused_decode" if layout == "paged"
               else "chai_fused_decode")
        want = {name: 0 for name in run["launches"]}
        want[own] = cfg.n_layers * (calls["mixed_step"]
                                    + calls["steady_step"])
        if run["launches"] != want:
            raise AssertionError(f"{layout}: launches {run['launches']}, "
                                 f"expected {want}")
        _log_served(run, f"continuous {layout}")
        if layout == "paged":
            _check_kv_bytes(run, "continuous paged")
        else:
            log(f"continuous dense (unified layout) resident KV bytes "
                f"{eng.kv_bytes():,}")
        runs[layout] = run
        del eng
        run.pop("eng")
        run.pop("prefill")
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError("paged and dense layouts gave different "
                             "greedy tokens")
    # The same step of the same tokens on both layouts: the two kernels'
    # layer-0 inputs hold the same logical K/V for every occupied row, so
    # their outputs there are bitwise equal (a FREE row reads the null
    # page on one layout and its stale rectangle on the other).
    pc = paged["capture"]["paged", "steady"]
    dc = dense["capture"]["dense", "steady"]
    if not torch.equal(pc["note"], dc["note"]):
        raise AssertionError("the layouts' first all-STEADY steps differ")
    live = pc["note"] != chai_cache.PHASE_FREE
    pa = (pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
          pc["h2c"], pc["pos"])
    paged_out = ck.paged_chai_fused_decode(*pa)
    dense_out = ck.chai_fused_decode(dc["q"], dc["k"], dc["v"], dc["h2c"],
                                     dc["pos"], ts=dc["kw"]["ts"])
    torch.cuda.synchronize()
    if not torch.equal(paged_out[live], dense_out[live]):
        raise AssertionError("paged vs dense kernel on the main path's "
                             "first all-STEADY step differ")
    err, ms, plain_ms = paged_decode_case(*pa, rpg=1)
    bound, by = fused_decode_bound(pc["q"], pc["k_pool"], pc["v_pool"],
                                   pc["h2c"], pc["pos"], 1,
                                   tables=(pc["bt_k"], pc["bt_v"]))
    dense_ms = time_ms(lambda: ck.chai_fused_decode(
        dc["q"], dc["k"], dc["v"], dc["h2c"], dc["pos"], ts=dc["kw"]["ts"]))
    single = single_call_ms(lambda: ck.paged_chai_fused_decode(*pa))
    dev_ms = device_ms(lambda: ck.paged_chai_fused_decode(*pa),
                       "paged_chai_fused_decode_kernel")
    # The first mixed step: its WARMUP rows run the kernel too (and their
    # output is discarded), with every head in cluster 0.
    mc = paged["capture"]["paged", "mixed"]
    ma = (mc["q"], mc["k_pool"], mc["bt_k"], mc["v_pool"], mc["bt_v"],
          mc["h2c"], mc["pos"])
    m_err, m_ms, m_plain_ms = paged_decode_case(*ma, rpg=1)
    log(f"continuous layer 0, first mixed step: phases "
        f"{mc['note'].tolist()}, pos {mc['pos'].tolist()}: paged kernel "
        f"{m_ms:.4f} ms (max_abs_err {m_err:.3e}, bitwise = dense kernel),"
        f" plain {m_plain_ms:.4f} ms")
    log(f"continuous layer 0, first all-STEADY step: q "
        f"{tuple(pc['q'].shape)}, k_pool {tuple(pc['k_pool'].shape)} "
        f"{pc['k_pool'].dtype}, v_pool {tuple(pc['v_pool'].shape)}, pos "
        f"{pc['pos'].tolist()}: paged kernel {ms:.4f} ms (single call "
        f"{single:.4f} ms, profiled device time {dev_ms} ms, max_abs_err "
        f"{err:.3e}, bitwise = dense kernel, dense kernel {dense_ms:.4f} "
        f"ms), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    main = dict(case="continuous_main_path_layer0", q=list(pc["q"].shape),
                k_pool=list(pc["k_pool"].shape),
                v_pool=list(pc["v_pool"].shape),
                dtype=str(pc["k_pool"].dtype), page=PAGE,
                pos=pc["pos"].tolist(), max_abs_err=err, ms=ms,
                single_call_ms=single, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, dense_kernel_ms=dense_ms)
    mixed = dict(case="continuous_first_mixed_step_layer0",
                 phases=mc["note"].tolist(), pos=mc["pos"].tolist(),
                 max_abs_err=m_err, ms=m_ms, plain_ms=m_plain_ms)
    mono = dict(tokens={r.uid: r.generated for r in paged["done"]},
                ttft={r.uid: r.ttft for r in paged["done"]},
                margins=paged["margins"], membership=paged["idents"],
                longest_step_s=max(paged["step_s"]))
    return ({"continuous_paged": paged["launches"],
             "continuous_dense": dense["launches"]}, main, mixed, mono, pc,
            {layout: _run_summary(run) for layout, run in runs.items()})


def _run_summary(run):
    """Wall, tok/s and ms per call of each step kind of a served run, its
    greedy tokens and its KV-bytes history."""
    n_tok = sum(len(r.generated) for r in run["done"])
    return dict(wall_s=run["wall"], tok_s=n_tok / run["wall"],
                ttft_mean_s=statistics.mean(r.ttft for r in run["done"]),
                step_ms={k: 1e3 * run["times"][k] / n
                         for k, n in run["calls"].items()},
                tokens={r.uid: r.generated for r in run["done"]},
                kv_history=run["kv_history"],
                device_peak_run=run["device_peak"] - run["device_start"])


# ------------------------------------------- phase 6b: the MHA baseline ----
def mha_baseline_path(cfg, params, chai, label):
    """The MHA baseline (``use_chai=False``) on the continuous engine with
    phase 6's traffic, paged then dense: every decode step runs
    ``paged_decode`` (paged) or ``flash_decode`` (dense) n_layers times
    and nothing else, the eager decode attention never; identical greedy
    tokens on both layouts; pools empty; wall, tok/s and step ms logged
    beside the CHAI runs of the same traffic (``chai``: their
    ``_run_summary``). Both kernels are then held against their plain
    versions on the layer-0 inputs of the first decode step with every
    slot occupied, timed there (with PyTorch's SDPA on the dense inputs),
    and held bitwise against each other there. Returns ({path: launches},
    {kernel: that case})."""
    runs, launches = {}, {}
    for layout in ("paged", "dense"):
        EAGER["calls"] = 0
        run = serve_continuous(cfg, params, layout, use_chai=False)
        eng, calls, done = run["eng"], run["calls"], run["done"]
        counts = [len(r.generated) for r in done]
        if (counts != list(CONT_MAX_NEW)
                or any(r.finish_reason != FINISH_LENGTH for r in done)
                or not all(0 <= t < cfg.vocab_size
                           for r in done for t in r.generated)):
            raise AssertionError(f"{label} {layout}: token counts {counts}")
        own = "paged_decode" if layout == "paged" else "flash_decode"
        want = {name: 0 for name in run["launches"]}
        want[own] = cfg.n_layers * calls.get("mha_step", 0)
        if (run["launches"] != want or not want[own] or EAGER["calls"]
                or set(calls) - {"prefill", "mha_step"}):
            raise AssertionError(f"{label} {layout}: launches "
                                 f"{run['launches']}, expected {want}; "
                                 f"eager decode calls {EAGER['calls']}; "
                                 f"calls {calls}")
        if eng.paged and (eng.dense_pool.pages_in_use
                          or eng.chai_pool is not None):
            raise AssertionError(f"{label} {layout}: pages left in use")
        _log_served(run, f"{label} {layout}")
        mine, theirs = _run_summary(run), chai[layout]
        chai_ms = {k: theirs["step_ms"].get(f"{k}_step", float("nan"))
                   for k in ("steady", "mixed", "warmup")}
        log(f"{label} {layout} against CHAI on the same traffic: "
            f"{mine['tok_s']:.1f} tok/s against {theirs['tok_s']:.1f}, wall "
            f"{mine['wall_s']:.3f} s against {theirs['wall_s']:.3f} s, TTFT "
            f"mean {mine['ttft_mean_s']:.4f} s against "
            f"{theirs['ttft_mean_s']:.4f} s; MHA step "
            f"{mine['step_ms']['mha_step']:.2f} ms against CHAI all-STEADY "
            f"{chai_ms['steady']:.2f} ms, mixed {chai_ms['mixed']:.2f} ms, "
            f"WARMUP {chai_ms['warmup']:.2f} ms")
        run["summary"] = mine
        run.pop("eng")
        launches[f"{label}_{layout}"] = run["launches"]
        runs[layout] = run
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError(f"{label}: paged and dense layouts gave "
                             "different greedy tokens")
    pc = paged["prefill"]["paged_decode", SLOTS]
    dc = dense["prefill"]["flash_decode", SLOTS]
    if not (torch.equal(pc["pos"], dc["pos"]) and torch.equal(pc["q"],
                                                              dc["q"])):
        raise AssertionError(f"{label}: the layouts' first full steps differ")
    pa = (pc["q"], pc["pool"], pc["bt_k"], pc["bt_v"], pc["pos"])
    da = (dc["q"], dc["k"], dc["v"], dc["pos"])
    ts = int(dc["ts"])
    cases = {}
    for name, args, kw in (("flash_decode", da, dict(ts=ts, library=True)),
                           ("paged_decode", pa, {})):
        rec, _ = flash_decode_case(name, args, profile=True, **kw)
        cases[name] = dict(case=f"{label}_first_full_step_layer0", **rec)
        _log_flash_decode(name, cases[name])
    if not torch.equal(fk.paged_decode(*pa), fk.flash_decode(*da, ts=ts)):
        raise AssertionError(f"{label}: paged_decode and flash_decode differ "
                             "on the main path's first full step")
    log(f"{label}: paged_decode == flash_decode bitwise on the layer-0 "
        f"inputs of the first full step (pos {pc['pos'].tolist()}); paged "
        f"== dense tokens for all {sum(CONT_MAX_NEW)}")
    return launches, cases


# ------------------------------------------------------------ phase 7 ----
def _hold_tokens(run, mono, label="chunked"):
    """Each request's greedy tokens against the monolithic run's, up to
    its first divergence, which must sit on a monolithic top-2 margin <=
    CHUNK_MARGIN. Returns (tokens held, tokens compared, divergences)."""
    held = compared = 0
    parted = []
    for r in run["done"]:
        want, gaps = mono["tokens"][r.uid], mono["margins"][r.uid]
        for k, (got, tok) in enumerate(zip(r.generated, want)):
            compared += 1
            if got != tok:
                if gaps[k] > CHUNK_MARGIN:
                    raise AssertionError(
                        f"{label} uid {r.uid} token {k}: {got} != {tok} at "
                        f"monolithic margin {gaps[k]:.4f} > {CHUNK_MARGIN}")
                parted.append((r.uid, k, round(gaps[k], 5)))
                break
            held += gaps[k] > CHUNK_MARGIN
    return held, compared, parted


def chunked_path(cfg, params, mono):
    """The chunked continuous path (phase 7): phase 6's paged run with
    ``prefill_chunk_tokens=CHUNK``, clustering each request through its
    phase-6 membership (its own K-Means still runs, so both runs pay for
    it, and is compared for information); returns
    (launches, the prefill kernels' main-path cases, their cases at the
    other chunk starts)."""
    run = serve_continuous(cfg, params, "paged", chunk=CHUNK,
                           membership=mono["membership"])
    eng, calls = run["eng"], run["calls"]
    _check_served(cfg, run, "chunked")
    n_chunks = sum(-(-n // CHUNK) for n in CONT_PROMPT_LENS if n > CHUNK)
    if calls.get("chunk") != n_chunks:
        raise AssertionError(f"chunked: {calls.get('chunk')} chunks, "
                             f"expected {n_chunks}")
    want = {name: 0 for name in run["launches"]}
    want["paged_chai_fused_decode"] = cfg.n_layers * (
        calls["mixed_step"] + calls["steady_step"])
    want["flash_prefill"] = want["paged_prefix_attend"] = (
        cfg.n_layers * n_chunks)
    if run["launches"] != want:
        raise AssertionError(f"chunked: launches {run['launches']}, "
                             f"expected {want}")
    _log_served(run, "continuous paged chunked")
    _check_kv_bytes(run, "continuous paged chunked")
    held, compared, parted = _hold_tokens(run, mono)
    own_same = sum(same for _, _, same in run["idents"].values())
    chunk_ms = 1e3 * run["times"]["chunk"] / calls["chunk"]
    log(f"chunked vs monolithic: {held} of {compared} tokens held at "
        f"margin > {CHUNK_MARGIN} (first divergences at near-ties: "
        f"{parted}); own K-Means membership equal to the monolithic run's "
        f"for {own_same} of {len(run['idents'])} requests; {n_chunks} "
        f"chunks, {chunk_ms:.2f} ms each; steps while chunks were in "
        f"flight: {run['in_flight']['mixed']} mixed, "
        f"{run['in_flight']['no_decode']} with no decode; TTFT mean "
        f"{statistics.mean(r.ttft for r in run['done']):.4f} s (monolithic "
        f"{statistics.mean(mono['ttft'].values()):.4f}); longest step "
        f"{1e3 * max(run['step_s']):.2f} ms (monolithic "
        f"{1e3 * mono['longest_step_s']:.2f})")
    cases = {"flash_prefill": [], "paged_prefix_attend": []}
    for (op, start), t in sorted(run["prefill"].items()):
        if op == "flash_prefill":
            case = flash_case(t["q"], t["k"], t["v"], library=start == 0)
        else:
            case = prefix_case(t["q"], t["pool"], t["bt_k"], t["bt_v"],
                               t["plen"])
        case = dict(case=f"chunk_start{start}_layer0", **case)
        cases[op].append(case)
        _log_case(f"{op} main path", case)
    mains = {"flash_prefill": cases["flash_prefill"][0],
             "paged_prefix_attend": cases["paged_prefix_attend"][-1]}
    f, p = (run["prefill"]["flash_prefill", 0],
            run["prefill"]["paged_prefix_attend", 3 * CHUNK])
    calls = {"flash_prefill": lambda: fk.flash_prefill(
        f["q"], f["k"], f["v"], emit_state=True),
             "paged_prefix_attend": lambda: fk.paged_prefix_attend(
        p["q"], p["pool"], p["bt_k"], p["bt_v"], p["plen"])}
    for op, call in calls.items():
        mains[op]["single_call_ms"] = single_call_ms(call)
        mains[op]["device_ms"] = device_ms(call, f"{op}_kernel")
        log(f"{op} main path: profiled device time "
            f"{mains[op]['device_ms']} ms, single call "
            f"{mains[op]['single_call_ms']:.4f} ms")
    if (mains["flash_prefill"]["q"][1] != CHUNK
            or mains["paged_prefix_attend"]["plen"] != [3 * CHUNK]):
        raise AssertionError(f"main-path prefill cases {mains}")
    return run["launches"], mains, cases


# ------------------------------------------------------------ phase 8 ----
def serve_prefix(cfg, params, relay):
    """Serve phase 8's traffic on a continuous paged engine with the
    prefix cache (and ``relay``: relay decode): the warm request to
    completion, then the rest. Launches counted over both; each step kind,
    each relay formation (the packed prefix views and their stack) and
    each ``step()`` timed; the decode ops' layer-0 inputs kept at the
    first step of each kind, the prefill ops' at the first suffix prefill;
    the top-2 margin behind every greedy token and each request's
    membership recorded."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        prefix_cache=True, relay_decode=relay))
    times, calls, kind = {}, {}, {"now": None}
    for attr, phase in (("_slot_prefill", "prefill"),
                        ("_suffix_prefill", "suffix_prefill"),
                        ("_mha_step", "warmup_step"),
                        ("_mixed_step", "mixed_step"),
                        ("_chai_step", "steady_step"),
                        ("_relay_step", "relay_step"),
                        ("_build_relay", "relay_form")):
        if hasattr(eng, attr):
            fn = _timed(getattr(eng, attr), phase, times, calls)

            def noted(*a, _fn=fn, _k=phase.split("_")[0]):
                kind["now"] = _k
                try:
                    return _fn(*a)
                finally:
                    kind["now"] = None
            setattr(eng, attr, noted)
    idents, own = {}, eng._identify

    def identify(sc):
        i = int(np.flatnonzero(eng._phases == chai_cache.PHASE_CLUSTER)[0])
        out = own(sc)
        idents[eng._slot_req[i].uid] = {k: v.clone() for k, v in out.items()}
        return out
    eng._identify = identify
    _check_logits(eng, cfg.vocab_size)
    margins = _record_margins(eng)
    step, step_s = eng.step, []

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out
    eng.step = timed_step
    cap = _Capture(lambda: kind["now"])
    pcap = _TransformerCapture(lambda: "first")
    warm, rest = _prefix_traffic(np.random.default_rng(0), cfg.vocab_size,
                                 SYS_LEN, SUFFIX_LENS, SUFFIX_NEW,
                                 cfg.chai.warmup_tokens + 1)
    chai_core.kops, tfm.kops = cap, pcap
    try:
        start = _memory_start()
        _reset_launches()
        t0 = time.time()
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
        eng.run()
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        for uid, prompt, m in rest:
            eng.submit(prompt, max_new_tokens=m, uid=uid)
        torch.cuda.synchronize()
        t0 = time.time()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launches()
    finally:
        chai_core.kops, tfm.kops = kops, kops
    run = dict(eng=eng, done=sorted(done, key=lambda r: r.uid), wall=wall,
               warm_s=warm_s, times=times, calls=calls, launches=launches,
               capture=cap.first, modes=cap.modes, prefill=pcap.first,
               margins=margins,
               idents=idents,
               step_s=step_s, warm=warm, rest=rest, device_start=start,
               device_peak=torch.cuda.max_memory_allocated())
    return run


def _check_prefix_run(cfg, run, label):
    """Plan kinds, token counts, launches and pools of one phase-8 run."""
    eng, done, calls = run["eng"], run["done"], run["calls"]
    warm, rest = run["warm"], run["rest"]
    want_hits = _expected_hits(warm, rest, SYS_LEN, snapshots=cfg.is_mha)
    hits = {r.uid: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
            for r in done}
    if hits != want_hits:
        raise AssertionError(f"{label}: plan kinds {hits}, expected "
                             f"{want_hits}")
    budgets = {uid: m for uid, _, m in [warm] + rest}
    if ({r.uid: len(r.generated) for r in done} != budgets
            or any(r.finish_reason != FINISH_LENGTH for r in done)):
        raise AssertionError(f"{label}: token counts")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of vocabulary")
    n_suffix = len(rest) - (2 if cfg.is_mha else 0)
    steps = (calls.get("relay_step", 0) + calls.get("mixed_step", 0)
             + calls.get("steady_step", 0))
    want = {name: 0 for name in run["launches"]}
    want["flash_prefill"] = want["paged_prefix_attend"] = (
        cfg.n_layers * n_suffix)
    want["paged_chai_fused_decode"] = cfg.n_layers * steps
    want["relay_prefix_decode"] = cfg.n_layers * eng.relay_steps
    if (run["launches"] != want or calls.get("suffix_prefill") != n_suffix
            or eng.relay_steps != calls.get("relay_step", 0)):
        raise AssertionError(f"{label}: launches {run['launches']}, "
                             f"expected {want}; calls {calls}")
    _check_modes(cfg, run, label)
    run["stats"] = eng.prefix_stats()
    run["kv_peak"] = eng.kv_bytes_peak()
    eng.prefix_cache.clear()
    if eng.dense_pool.pages_in_use or (eng.chai_pool is not None
                                       and eng.chai_pool.pages_in_use):
        raise AssertionError(f"{label}: pools not empty after clear()")


def _log_prefix_run(run, label):
    eng, done, calls = run["eng"], run["done"], run["calls"]
    rest = [r for r in done if r.uid != run["warm"][0]]
    n_tok = sum(len(r.generated) for r in rest)
    per_call = {k: 1e3 * run["times"][k] / calls[k] for k in calls}
    log(f"{label}: warm request {run['warm_s']:.3f} s; then {len(rest)} "
        f"requests, {n_tok} tokens in {run['wall']:.3f} s: "
        f"{n_tok / run['wall']:.1f} tok/s, TTFT "
        f"{[round(r.ttft, 4) for r in rest]} s (mean "
        f"{statistics.mean(r.ttft for r in rest):.4f}); decode steps "
        f"{eng.steps_executed}, by kind {calls}; relay steps "
        f"{eng.relay_steps}, grouped slot-steps {eng.relay_grouped_slots}; "
        f"launches {run['launches']}")
    log(f"{label} by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in run["times"].items())
        + "; ms per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in per_call.items())
        + f"; engine steps {len(run['step_s'])}, longest "
        f"{1e3 * max(run['step_s']):.2f} ms; KV bytes peak "
        f"{run['kv_peak']:,}; device memory peak {run['device_peak']:,} B "
        f"({run['device_peak'] - run['device_start']:,} B above the run's "
        "start); "
        f"prefix_stats {run['stats']}")


def prefix_path(cfg, params, tag="prefix"):
    """The prefix cache and relay decode at full width (phase 8, and for
    nemotron-4-15b phase 9): the same traffic with
    ``relay_decode=False``, then ``True``. A GQA model takes no CHAI
    snapshot, so its repeated prompt is a ``"prefix"`` hit like the
    others. An int8 ``cfg`` runs the same checks on its int8 kernels.
    Returns ({path: launches}, the relay kernel's main-path case, the
    paged kernel's state-mode case there, and ``paged_prefix_attend``'s
    case on the layer-0 inputs of the relay-off run's first suffix
    prefill)."""
    runs = {}
    for label, relay in ((f"{tag}_plain", False), (f"{tag}_relay", True)):
        run = serve_prefix(cfg, params, relay)
        _check_prefix_run(cfg, run, label)
        _log_prefix_run(run, label)
        run.pop("eng")
        runs[label] = run
        torch.cuda.empty_cache()
    plain, relay = runs[f"{tag}_plain"], runs[f"{tag}_relay"]
    if plain["calls"].get("relay_step") or not relay["calls"].get(
            "relay_step"):
        raise AssertionError(f"relay steps: plain {plain['calls']}, relay "
                             f"{relay['calls']}")
    # Relay touches only STEADY steps: every WARMUP buffer, hence every
    # membership, is the same in both runs.
    if sorted(plain["idents"]) != sorted(relay["idents"]) or not all(
            torch.equal(plain["idents"][u][k], relay["idents"][u][k])
            for u in plain["idents"] for k in plain["idents"][u]):
        raise AssertionError("relay and plain runs clustered differently")
    mono = dict(tokens={r.uid: r.generated for r in plain["done"]},
                margins=plain["margins"])
    # The warm request decodes alone (no group), and the snapshot and
    # replay requests of an MHA model take no relay step: theirs must be
    # identical; a GQA model's repeats decode in groups like the rest.
    exact = (relay["warm"][0],) + (tuple(r[0] for r in relay["rest"][-2:])
                                   if cfg.is_mha else ())
    for uid in exact:
        if mono["tokens"][uid] != [r.generated for r in relay["done"]
                                   if r.uid == uid][0]:
            raise AssertionError(f"{tag}_relay uid {uid}: tokens differ "
                                 "from the plain run")
    grouped = dict(relay, done=[r for r in relay["done"]
                                if r.uid not in exact])
    held, compared, parted = _hold_tokens(grouped, mono)
    def per(run, k):
        return (1e3 * run["times"][k] / run["calls"][k]
                if run["calls"].get(k) else float("nan"))
    form = relay["times"]["relay_form"] / relay["calls"]["relay_form"]
    same = sum(r.generated == mono["tokens"][r.uid] for r in relay["done"])
    log(f"{tag} relay vs plain: {held} of {compared} grouped-request tokens "
        f"held at plain margin > {CHUNK_MARGIN} (first divergences at "
        f"near-ties: {parted}); requests {exact} identical, and "
        f"{same} of {len(relay['done'])} requests identical in all; "
        f"memberships identical for {len(plain['idents'])} requests; mean "
        f"relay step {per(relay, 'relay_step'):.2f} ms against a plain "
        f"run's all-STEADY step {per(plain, 'steady_step'):.2f} ms and "
        f"mixed step {per(plain, 'mixed_step'):.2f} ms (the relay run's "
        f"own all-STEADY steps {per(relay, 'steady_step'):.2f} ms); relay "
        f"formation (packed views + stack) {1e3 * form:.3f} ms per step; "
        f"wall {relay['wall']:.3f} s against {plain['wall']:.3f} s")
    rc = relay["capture"]["relay", "relay"]
    ra = (rc["q"], rc["k"], rc["v"], rc["k_row"], rc["a_row"], rc["v_row"],
          rc["plen"])
    rsc = {k: rc["kw"].get(k) for k in ("k_scale", "v_scale")}
    # share_values under int8 reads raw V codes (up to 127): its acc rows
    # are held over their l, as phase 3's share relay cases are
    raw_v = rc["v"].dtype == torch.int8 and rsc["v_scale"] is None
    relay_main = dict(case=f"{tag}_relay_first_relay_step_layer0",
                      **relay_case(*ra, ts=rc["kw"]["ts"], per_l=raw_v,
                                   **rsc))
    call = lambda: ck.relay_prefix_decode(  # noqa: E731
        *ra, ts=rc["kw"]["ts"], **rsc)
    relay_main["single_call_ms"] = single_call_ms(call)
    relay_main["stack_ms_per_step"] = 1e3 * form
    _log_relay(relay_main)
    log(f"relay_prefix_decode {tag} (layer 0, first relay step, "
        f"{relay_main['dtype']}): single call "
        f"{relay_main['single_call_ms']:.4f} ms, profiled device time "
        f"{relay_main['device_ms']} ms against a bound of "
        f"{relay_main['bound_ms']:.4f} ms")
    pc = relay["capture"]["paged", "relay"]
    pa = (pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
          pc["h2c"], pc["pos"])
    kw = dict(pc["kw"], emit_state=True)
    got = ck.paged_chai_fused_decode(*pa, **kw)
    want = kref.paged_chai_fused_decode_ref(*pa, **kw)
    if raw_v:       # raw int8 V codes: acc rows held over their l
        got, want = _share_per_l(got), _share_per_l(want)
    err = _hold(got, want)
    emit_main = dict(case=f"{tag}_relay_first_relay_step_layer0_emit_state",
                     emit_state=True, pos=pc["pos"].tolist(), max_abs_err=err,
                     ms=time_ms(lambda: ck.paged_chai_fused_decode(*pa,
                                                                   **kw)),
                     plain_ms=time_ms(lambda: kref.paged_chai_fused_decode_ref(
                         *pa, **kw)))
    log(f"paged_chai_fused_decode state mode at the same step (suffix-only "
        f"tables, pos {emit_main['pos']}): max_abs_err {err:.3e}, kernel "
        f"{emit_main['ms']:.4f} ms, plain {emit_main['plain_ms']:.4f} ms")
    pp = plain["prefill"]["paged_prefix_attend", "first"]
    pargs = (pp["q"], pp["pool"], pp["bt_k"], pp["bt_v"], pp["plen"])
    psc = {k: pp[k] for k in ("k_scale_pool", "v_scale_pool") if k in pp}
    prefix_main = dict(case=f"{tag}_first_suffix_prefill_layer0",
                       **prefix_case(*pargs, **psc))
    pcall = lambda: fk.paged_prefix_attend(*pargs, **psc)  # noqa: E731
    prefix_main["single_call_ms"] = single_call_ms(pcall)
    prefix_main["device_ms"] = device_ms(pcall, "paged_prefix_attend_kernel")
    _log_case("paged_prefix_attend", prefix_main)
    return ({f"{tag}_plain": plain["launches"],
             f"{tag}_relay": relay["launches"]}, relay_main, emit_main,
            prefix_main)


# ------------------------------------------------------------ phase 9 ----
def _check_gqa_kv_bytes(run, label):
    """GQA keeps every dense K/V page until retirement (the reference's
    behaviour: no clustered pool, nothing freed at CLUSTER), so the
    allocated KV bytes do not move at a CLUSTER transition; the pool is
    empty at the end."""
    eng = run["eng"]
    hist = eng.kv_bytes_history
    around = [(before, hist[idx]["kv_bytes"])
              for before, idx, _ in run["transitions"]]
    if (len(around) != len(run["traffic"][0])
            or any(after != before for before, after in around)):
        raise AssertionError(f"{label}: KV bytes around CLUSTER: {around}")
    if eng.chai_pool is not None or eng.dense_pool.pages_in_use:
        raise AssertionError(f"{label}: a clustered pool, or pages left in "
                             "use")
    log(f"{label} KV bytes at each CLUSTER transition (unchanged, GQA keeps "
        f"its dense pages): {[b for b, _ in around]}; peak "
        f"{eng.kv_bytes_peak():,}, capacity {eng.kv_bytes_capacity():,}, at "
        f"the end {eng.kv_bytes():,}")


def nemotron_path(cfg, params):
    """Full-width nemotron-4-15b (GQA) through the default continuous
    engine, phase 6's traffic, on the paged layout and then the dense one
    (phase 9): launches of the own fused kernel only (n_layers per mixed
    or all-STEADY step, each with reps_per_group = r_max), identical
    greedy tokens, KV bytes unchanged at CLUSTER, empty pools, and both
    fused kernels held against their plain versions on the layer-0 GQA
    tensors of the first all-STEADY step. Returns ({path: launches},
    {kernel: [cases]}, the dense and paged captures of that step)."""
    _, r_max = clustering.chai_widths(cfg)
    runs = {}
    for layout in ("paged", "dense"):
        label = f"{cfg.name} {layout}"
        run = serve_continuous(cfg, params, layout)
        calls = run["calls"]
        _check_served(cfg, run, label)
        own, op = (("paged_chai_fused_decode", "paged") if layout == "paged"
                   else ("chai_fused_decode", "dense"))
        want = {name: 0 for name in run["launches"]}
        want[own] = cfg.n_layers * (calls["mixed_step"]
                                    + calls["steady_step"])
        if run["launches"] != want:
            raise AssertionError(f"{label}: launches {run['launches']}, "
                                 f"expected {want}")
        for kind in ("steady", "mixed"):
            rpg = run["capture"][op, kind]["kw"].get("reps_per_group")
            if rpg != r_max:
                raise AssertionError(f"{label}: reps_per_group {rpg}, "
                                     f"expected r_max = {r_max}")
        _log_served(run, label)
        if layout == "paged":
            _check_gqa_kv_bytes(run, label)
        else:
            log(f"{label} (unified layout) resident KV bytes "
                f"{run['eng'].kv_bytes():,}")
        run.pop("eng")
        run.pop("prefill")
        runs[layout] = run
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError(f"{cfg.name}: paged and dense layouts gave "
                             "different greedy tokens")
    pc = paged["capture"]["paged", "steady"]
    dc = dense["capture"]["dense", "steady"]
    pa = (pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
          pc["h2c"], pc["pos"])
    p_err, p_ms, p_plain = paged_decode_case(*pa, rpg=r_max)
    p_bound, p_by = fused_decode_bound(pc["q"], pc["k_pool"], pc["v_pool"],
                                       pc["h2c"], pc["pos"], r_max,
                                       tables=(pc["bt_k"], pc["bt_v"]))
    da = (dc["q"], dc["k"], dc["v"], dc["h2c"], dc["pos"])
    d_err, d_ms, d_plain = fused_decode_case(*da, rpg=r_max,
                                             ts=dc["kw"]["ts"])
    d_bound, d_by = fused_decode_bound(*da, r_max)
    cases = {
        "paged_chai_fused_decode": [dict(
            case="nemotron_paged_first_steady_layer0", q=list(pc["q"].shape),
            k_pool=list(pc["k_pool"].shape), rpg=r_max,
            dtype=str(pc["k_pool"].dtype), pos=pc["pos"].tolist(),
            max_abs_err=p_err, ms=p_ms, plain_ms=p_plain, bound_ms=p_bound,
            bound_by=p_by, bitwise_equal_dense=True)],
        "chai_fused_decode": [dict(
            case="nemotron_dense_first_steady_layer0", q=list(dc["q"].shape),
            k=list(dc["k"].shape), rpg=r_max, dtype=str(dc["k"].dtype),
            pos=dc["pos"].tolist(), max_abs_err=d_err, ms=d_ms,
            plain_ms=d_plain, bound_ms=d_bound, bound_by=d_by)]}
    n_tok = sum(len(r.generated) for r in paged["done"])
    log(f"{cfg.name} layer 0, first all-STEADY step (GQA, reps_per_group "
        f"{r_max}): paged kernel q {tuple(pc['q'].shape)} k_pool "
        f"{tuple(pc['k_pool'].shape)} pos {pc['pos'].tolist()}: {p_ms:.4f} ms"
        f" (max_abs_err {p_err:.3e}, bitwise = dense kernel), plain "
        f"{p_plain:.4f} ms, bound {p_bound:.4f} ms ({p_by}); dense kernel "
        f"{d_ms:.4f} ms (max_abs_err {d_err:.3e}), plain {d_plain:.4f} ms, "
        f"bound {d_bound:.4f} ms ({d_by}); paged == dense tokens for all "
        f"{n_tok}; TTFT mean paged "
        f"{statistics.mean(r.ttft for r in paged['done']):.4f} s, dense "
        f"{statistics.mean(r.ttft for r in dense['done']):.4f} s")
    return ({"nemotron_paged": paged["launches"],
             "nemotron_dense": dense["launches"]}, cases, dc, pc,
            {layout: _run_summary(run) for layout, run in runs.items()})


# ----------------------------------------------------------- phase 11 ----
def _first_all_steady(hist, label):
    """The KV-bytes record of a run's first all-STEADY decode step."""
    for rec in hist:
        if rec["n_steady"] and not rec["n_warmup"]:
            return rec
    raise AssertionError(f"{label}: no all-STEADY step")


def _check_int8_bytes(cfg8, hist8, hist16, label):
    """``kv_bytes()`` at the first all-STEADY step of an int8 run against
    the model-dtype run of the same traffic: the same step and pages in
    use, and exactly (hd + 4) / (2 hd) of the bytes for a bf16 model (132 /
    256 at hd 128: a byte a code and a row's 4-byte scale against two bytes
    a value), as is every page's ratio."""
    a = _first_all_steady(hist8, label)
    b = _first_all_steady(hist16, label)
    hd = cfg8.head_dim
    cfg16 = cfg8.replace(kv_cache_dtype="")
    den = hd * tfm.model_dtype(cfg16).itemsize       # 2 hd for bf16
    kinds = ("dense", "chai") if cfg8.is_mha else ("dense",)
    page8 = {k: chai_cache.paged_page_bytes(cfg8, PAGE, kind=k)
             for k in kinds}
    page16 = {k: chai_cache.paged_page_bytes(cfg16, PAGE, kind=k)
              for k in kinds}
    if ((a["step"], a["dense_pages"], a["chai_pages"])
            != (b["step"], b["dense_pages"], b["chai_pages"])
            or a["kv_bytes"] * den != b["kv_bytes"] * (hd + 4)
            or any(page8[k] * den != page16[k] * (hd + 4)
                   for k in kinds)):
        raise AssertionError(f"{label}: int8 {a}, bf16 {b}, page bytes "
                             f"{page8} against {page16}")
    log(f"{label}: kv_bytes() at the first all-STEADY step (step "
        f"{a['step']}, {a['dense_pages']} dense + {a['chai_pages']} "
        f"clustered pages): int8 {a['kv_bytes']:,} B against bf16 "
        f"{b['kv_bytes']:,} B = {a['kv_bytes']}/{b['kv_bytes']} = "
        f"{hd + 4}/{den} exactly; page bytes {page8} against {page16}")
    return dict(step=a["step"], int8=a["kv_bytes"], bf16=b["kv_bytes"])


def int8_path(cfg8, params, bf16, label):
    """One model with ``kv_cache_dtype="int8"`` through the default
    continuous engine on phase 6's traffic, paged then dense (phase 11):
    launches of the layout's own fused kernel only (its int8 mode), the
    same greedy tokens on both layouts, ``kv_bytes()`` at the first
    all-STEADY step against the bf16 run (``bf16``: its ``_run_summary``
    per layout; greedy agreement with it logged, information only), the
    KV bytes around CLUSTER as the bf16 run's, empty pools; then both
    fused kernels held against their plain versions on the layer-0 int8
    tensors of the first all-STEADY step and timed there. Returns
    ({path: launches}, {kernel: that case}, {layout: _run_summary})."""
    runs, launches = {}, {}
    for layout in ("paged", "dense"):
        name = f"{label}_{layout}"
        run = serve_continuous(cfg8, params, layout)
        calls = run["calls"]
        _check_served(cfg8, run, name)
        own = ("paged_chai_fused_decode" if layout == "paged"
               else "chai_fused_decode")
        want = {k: 0 for k in run["launches"]}
        want[own] = cfg8.n_layers * (calls["mixed_step"]
                                     + calls["steady_step"])
        if run["launches"] != want:
            raise AssertionError(f"{name}: launches {run['launches']}, "
                                 f"expected {want}")
        _log_served(run, name)
        if layout == "paged":
            (_check_kv_bytes if cfg8.is_mha else _check_gqa_kv_bytes)(
                run, name)
            _check_int8_bytes(cfg8, run["kv_history"],
                              bf16["paged"]["kv_history"], name)
        mine, theirs = _run_summary(run), bf16[layout]
        agree = sum(a == b for u, toks in mine["tokens"].items()
                    for a, b in zip(toks, theirs["tokens"][u]))
        log(f"{name}: device memory peak above the run's start "
            f"{mine['device_peak_run']:,} B against bf16 "
            f"{theirs['device_peak_run']:,} B; "
            f"{mine['tok_s']:.1f} tok/s against bf16 {theirs['tok_s']:.1f}, "
            f"TTFT mean {mine['ttft_mean_s']:.4f} s against "
            f"{theirs['ttft_mean_s']:.4f} s, step ms {mine['step_ms']} "
            f"against {theirs['step_ms']}; information only (random "
            f"weights): greedy agreement with bf16 {agree}/"
            f"{sum(CONT_MAX_NEW)}")
        launches[name] = run["launches"]
        run.pop("eng")
        run.pop("prefill")
        runs[layout] = run
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError(f"{label}: paged and dense layouts gave "
                             "different greedy tokens")
    pc = paged["capture"]["paged", "steady"]
    dc = dense["capture"]["dense", "steady"]
    if pc["k_pool"].dtype != torch.int8 or dc["k"].dtype != torch.int8:
        raise AssertionError(f"{label}: the captured caches are not int8")
    return (launches, first_steady_cases(label, pc, dc),
            {layout: _run_summary(run) for layout, run in runs.items()})


def first_steady_cases(label, pc, dc):
    """Both fused kernels held against their plain versions on the layer-0
    tensors of a run's first all-STEADY step (``pc``/``dc``: the paged and
    dense runs' captures, in whatever mode they ran: int8 scales,
    share_values and the softcap as captured), the paged one bitwise
    against the dense
    kernel at page = tile, each timed there (device, back to back, single)
    beside its bound. Returns {kernel: case}."""
    rpg = pc["kw"].get("reps_per_group", 1)
    share = bool(pc["kw"].get("share_values"))
    pa = (pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
          pc["h2c"], pc["pos"])
    cap = float(pc["kw"].get("softcap", 0.0))
    psc = {k: pc["kw"][k] for k in ("k_scale_pool", "v_scale_pool",
                                    "share_values", "softcap")
           if k in pc["kw"]}
    da = (dc["q"], dc["k"], dc["v"], dc["h2c"], dc["pos"])
    dsc = {k: dc["kw"][k] for k in ("k_scale", "v_scale", "share_values",
                                    "softcap")
           if dc["kw"].get(k) is not None}
    cases = {}
    for kernel, case_fn, args, tables, kk, vv, sc, extra in (
            ("paged_chai_fused_decode", paged_decode_case, pa,
             (pc["bt_k"], pc["bt_v"]), pc["k_pool"], pc["v_pool"], psc, {}),
            ("chai_fused_decode", fused_decode_case, da, (), dc["k"],
             dc["v"], dsc, dict(ts=dc["kw"]["ts"]))):
        err, ms, plain_ms = case_fn(*args, rpg=rpg, **sc, **extra)
        bound, by = fused_decode_bound(args[0], kk, vv, args[-2], args[-1],
                                       rpg, tables=tables, share=share,
                                       softcap=bool(cap))
        fn = getattr(ck, kernel)
        call = lambda fn=fn, a=args, kw=dict(  # noqa: E731
            reps_per_group=rpg, **sc, **extra): fn(*a, **kw)
        cases[kernel] = dict(
            case=f"{label}_{'paged' if tables else 'dense'}_first_steady"
                 "_layer0", q=list(args[0].shape), k=list(kk.shape),
            v=list(vv.shape), dtype=str(kk.dtype), rpg=rpg,
            share_values=share, softcap=cap, pos=args[-1].tolist(),
            max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            single_call_ms=single_call_ms(call),
            device_ms=device_ms(call, f"{kernel}_kernel"))
        c = cases[kernel]
        log(f"{kernel} {c['case']}: q {tuple(c['q'])} k {tuple(c['k'])} "
            f"v {tuple(c['v'])} {c['dtype']} pos {c['pos']}: max_abs_err "
            f"{err:.3e}, device {c['device_ms']} ms, back to back {ms:.4f} "
            f"ms, single call {c['single_call_ms']:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return cases


def int8_mha_path(cfg8, params, label):
    """The MHA baseline (``use_chai=False``) on an int8 cache, phase 6's
    traffic, paged then dense: every decode step reads the dequantized
    view through ``flash_decode`` (n_layers launches a step, on both
    layouts: the flash decode pair has no scale mode, as in the
    reference), never ``paged_decode`` nor the eager attention; the same
    greedy tokens on both layouts; pools empty. Returns {path:
    launches}."""
    runs, launches = {}, {}
    for layout in ("paged", "dense"):
        name = f"{label}_{layout}"
        EAGER["calls"] = 0
        run = serve_continuous(cfg8, params, layout, use_chai=False)
        eng, calls, done = run["eng"], run["calls"], run["done"]
        if ([len(r.generated) for r in done] != list(CONT_MAX_NEW)
                or any(r.finish_reason != FINISH_LENGTH for r in done)):
            raise AssertionError(f"{name}: token counts")
        want = {k: 0 for k in run["launches"]}
        want["flash_decode"] = cfg8.n_layers * calls.get("mha_step", 0)
        if (run["launches"] != want or not want["flash_decode"]
                or EAGER["calls"] or set(calls) - {"prefill", "mha_step"}):
            raise AssertionError(f"{name}: launches {run['launches']}, "
                                 f"expected {want}; eager decode calls "
                                 f"{EAGER['calls']}; calls {calls}")
        if eng.paged and eng.dense_pool.pages_in_use:
            raise AssertionError(f"{name}: pages left in use")
        _log_served(run, name)
        launches[name] = run["launches"]
        run.pop("eng")
        runs[layout] = run
        torch.cuda.empty_cache()
    if [r.generated for r in runs["paged"]["done"]] != [
            r.generated for r in runs["dense"]["done"]]:
        raise AssertionError(f"{label}: paged and dense layouts gave "
                             "different greedy tokens")
    return launches


# ----------------------------------------------------------- phase 12 ----
def _check_share_kv_bytes(cfg_s, run, konly_hist, label):
    """A share_values paged run's KV bytes: at every CLUSTER transition
    they fall by exactly the slot's dense K and V pages (its clustered K
    and V pages were reserved at admission); both pools empty at the end;
    at the first all-STEADY step exactly 2 k_max / (k_max + H) (50/57 on
    chai-llama-7b) of the K-only run's on the same traffic: the same step,
    no dense page, twice its clustered pages. Returns the two byte
    counts."""
    eng = run["eng"]
    hist = eng.kv_bytes_history
    dense_page = chai_cache.paged_page_bytes(cfg_s, PAGE, kind="dense")
    falls = [(before, hist[idx]["kv_bytes"], n)
             for before, idx, n in run["transitions"]]
    if (len(falls) != len(CONT_PROMPT_LENS)
            or not all(n and before - after == n * dense_page
                       for before, after, n in falls)):
        raise AssertionError(f"{label}: KV bytes around CLUSTER (before, "
                             f"after, dense pages) {falls}, a dense page "
                             f"{dense_page} B")
    if eng.dense_pool.pages_in_use or eng.chai_pool.pages_in_use:
        raise AssertionError(f"{label}: pools not empty after the run")
    a = _first_all_steady(hist, label)
    b = _first_all_steady(konly_hist, label)
    k_max, h = cfg_s.k_max, cfg_s.n_heads
    if (a["step"] != b["step"] or a["dense_pages"]
            or a["chai_pages"] != 2 * b["chai_pages"]
            or a["kv_bytes"] * (k_max + h) != b["kv_bytes"] * 2 * k_max):
        raise AssertionError(f"{label}: share {a}, K-only {b}")
    log(f"{label} KV bytes (before -> after, dense pages freed) at each "
        f"CLUSTER: {falls}; at the first all-STEADY step (step "
        f"{a['step']}, {a['chai_pages']} clustered pages, no dense page): "
        f"{a['kv_bytes']:,} B against the K-only run's {b['kv_bytes']:,} B "
        f"({b['dense_pages']} dense + {b['chai_pages']} clustered) = "
        f"{2 * k_max}/{k_max + h} exactly; peak {eng.kv_bytes_peak():,}, "
        f"capacity {eng.kv_bytes_capacity():,}")
    return dict(step=a["step"], share=a["kv_bytes"], konly=b["kv_bytes"])


def share_continuous(cfg_s, params, konly, label):
    """Phase 6's traffic with ``share_values``, paged then dense: launches
    of the layout's own fused kernel only, every call in the share mode;
    paged == dense greedy tokens; the paged run's KV bytes
    (``_check_share_kv_bytes`` against ``konly``, the K-only run's
    summaries); tok/s, TTFT and step ms beside the K-only run's; both
    fused kernels held on the first all-STEADY step's layer-0 tensors.
    Returns ({path: launches}, {kernel: case}, the KV-bytes record, the
    dense run's capture of that step)."""
    runs, launches, kv = {}, {}, None
    for layout in ("paged", "dense"):
        name = f"{label}_{layout}"
        run = serve_continuous(cfg_s, params, layout)
        calls = run["calls"]
        _check_served(cfg_s, run, name)
        own = ("paged_chai_fused_decode" if layout == "paged"
               else "chai_fused_decode")
        want = {k: 0 for k in run["launches"]}
        want[own] = cfg_s.n_layers * (calls["mixed_step"]
                                      + calls["steady_step"])
        modes = {(layout, True): want[own]}
        if run["launches"] != want or run["modes"] != modes:
            raise AssertionError(f"{name}: launches {run['launches']}, "
                                 f"expected {want}; calls by mode "
                                 f"{run['modes']}, expected {modes}")
        _log_served(run, name)
        if layout == "paged":
            kv = _check_share_kv_bytes(cfg_s, run,
                                       konly["paged"]["kv_history"], name)
        else:
            log(f"{name} (unified layout) resident KV bytes "
                f"{run['eng'].kv_bytes():,}")
        mine, theirs = _run_summary(run), konly[layout]
        agree = sum(a == b for u, toks in mine["tokens"].items()
                    for a, b in zip(toks, theirs["tokens"][u]))
        log(f"{name}: {mine['tok_s']:.1f} tok/s against K-only "
            f"{theirs['tok_s']:.1f}, TTFT mean {mine['ttft_mean_s']:.4f} s "
            f"against {theirs['ttft_mean_s']:.4f} s, step ms "
            f"{mine['step_ms']} against {theirs['step_ms']}; device memory "
            f"peak above the run's start {mine['device_peak_run']:,} B "
            f"against {theirs['device_peak_run']:,} B; information only "
            f"(random weights): greedy agreement with K-only {agree}/"
            f"{sum(CONT_MAX_NEW)}")
        launches[name] = run["launches"]
        run.pop("eng")
        run.pop("prefill")
        runs[layout] = run
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError(f"{label}: paged and dense layouts gave "
                             "different greedy tokens")
    pc = paged["capture"]["paged", "steady"]
    dc = dense["capture"]["dense", "steady"]
    if not (pc["kw"].get("share_values") and dc["kw"].get("share_values")
            and pc["v_pool"].shape[1] == dc["v"].shape[1] == cfg_s.k_max):
        raise AssertionError(f"{label}: the captured calls are not in the "
                             "share mode")
    return launches, first_steady_cases(label, pc, dc), kv, dc


def share_path(cfg, params, konly, konly8):
    """Phase 12: full-width chai-llama-7b with ``cfg.with_chai(
    share_values=True)`` (CHAI-QKV): the cohort on phase 5's traffic
    (launches of ``chai_fused_decode`` in the share mode only, the kernel
    held on the first STEADY step's layer-0 tensors); phase 6's traffic,
    paged then dense, bf16 (``konly``: phase 6's summaries) and int8
    (``konly8``: phase 11's); phase 8's prefix traffic on the first
    ``SIDE_DEPTH`` layers, relay off then on, bf16 and int8. Returns
    ({path: launches}, {row: (main case, path, cases)} for the three
    ``[share]`` rows' path cases, the int8 dense
    run's capture of its first all-STEADY step (phase 10's share lane))."""
    cfg_s = cfg.with_chai(share_values=True)
    cap = _Capture()
    chai_core.kops = cap
    try:
        _reset_launches()
        eng, done, wall, phases = serve(cfg_s, params, use_chai=True)
        cohort = _launches()
    finally:
        chai_core.kops = kops
    if ([len(r.generated) for r in done] != [MAX_NEW] * len(PROMPT_LENS)
            or not all(0 <= t < cfg.vocab_size for r in done
                       for t in r.generated)):
        raise AssertionError("share cohort: token counts or ids")
    want = {name: 0 for name in cohort}
    want["chai_fused_decode"] = ((MAX_NEW - 1 - cfg.chai.warmup_tokens)
                                 * cfg.n_layers)
    if cohort != want or cap.modes != {("dense", True):
                                       want["chai_fused_decode"]}:
        raise AssertionError(f"share cohort launches {cohort}, expected "
                             f"{want}; calls by mode {cap.modes}")
    first = cap.first["dense", "first"]
    fa = (first["q"], first["k"], first["v"], first["h2c"], first["pos"])
    err, ms, plain_ms = fused_decode_case(*fa, rpg=1, ts=first["kw"]["ts"],
                                          share_values=True)
    bound, by = fused_decode_bound(*fa, 1, share=True)
    cohort_case = dict(case="share_cohort_first_steady_layer0",
                       q=list(first["q"].shape), v=list(first["v"].shape),
                       pos=first["pos"].tolist(), share_values=True,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by)
    n_tok = sum(len(r.generated) for r in done)
    kc, kk = eng.kv_bytes(chai=True), chai_cache.kv_cache_bytes(
        cfg, SLOTS, MAX_SEQ, chai=True)
    log(f"share cohort: {len(done)} requests in {wall:.3f} s, "
        f"{n_tok / wall:.1f} tok/s, launches {cohort} (every call in the "
        f"share mode); by phase " + ", ".join(
            f"{k} {v:.4f}" for k, v in phases.items())
        + f"; layer 0, first STEADY step: v {tuple(first['v'].shape)}, "
        f"max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); analytic KV "
        f"bytes {kc:,} against K-only CHAI {kk:,} ({kc / kk:.4f})")
    del eng
    launches = {"share_cohort": cohort}
    cont, cont_cases, kv, _ = share_continuous(*cut_depth(cfg_s, params),
                                            konly, "share_continuous")
    cfg_s8 = cfg_s.replace(kv_cache_dtype="int8")
    cont8, cont8_cases, kv8, cap8 = share_continuous(
        *cut_depth(cfg_s8, params), konly8, "share_int8_continuous")
    pre, relay_main, emit_main, prefix_main = prefix_path(
        *cut_depth(cfg_s, params), tag="share_prefix")
    pre8, relay8, emit8, prefix8 = prefix_path(*cut_depth(cfg_s8, params),
                                               tag="share_int8_prefix")
    for part in (cont, cont8, pre, pre8):
        launches.update(part)
    log(f"share KV bytes at the first all-STEADY step: bf16 {kv}, int8 "
        f"{kv8}")
    mains = {
        "chai_fused_decode": (
            cont_cases["chai_fused_decode"], "share_continuous_dense",
            [cohort_case, cont_cases["chai_fused_decode"],
             cont8_cases["chai_fused_decode"]]),
        "paged_chai_fused_decode": (
            cont_cases["paged_chai_fused_decode"], "share_continuous_paged",
            [cont_cases["paged_chai_fused_decode"],
             cont8_cases["paged_chai_fused_decode"], emit_main, emit8]),
        "relay_prefix_decode": (relay_main, "share_prefix_relay",
                                [relay_main, relay8])}
    return launches, mains, cap8


# ----------------------------------------------------------- phase 10 ----
def reference_lane_input(seed=0):
    """The reference's fused-vs-pipeline lane shape
    (``benchmarks/bench_latency.py``): b=4, h=8, r=5, s=256, hd=32, ts=64,
    fp32, made from ``seed`` with numpy as there."""
    rng = np.random.default_rng(seed)
    b, h, r, s, hd, ts = 4, 8, 5, 256, 32, 64

    def dev(x, dtype=np.float32):
        return torch.from_numpy(np.asarray(x, dtype)).cuda()
    return dict(q=dev(rng.normal(size=(b, r, hd))),
                k=dev(rng.normal(size=(b, r, s, hd))),
                v=dev(rng.normal(size=(b, h, s, hd))),
                h2c=dev(rng.integers(0, r, size=(b, h)), np.int32),
                pos=dev(rng.integers(s // 2, s, size=b), np.int32),
                kw=dict(ts=ts))


def lane_calls(kind, t, rpg, int8):
    """(pipeline call, fused call, the fused kernel's name) on one lane
    input. A share_values capture (phase 12, int8: K codes with their
    scales, the clustered V's raw codes) runs both sides on its own
    tensors and scales: the pipeline's AV on int8 codes, the fused
    kernel's share mode. Otherwise int8 K (the port's ``quant_rows`` of
    the input's K) with float V: the pipeline runs ``chai_qk_i8``, the
    fused kernel its int8 K beside float V pairing (a mode the Pallas
    kernel accepts and no path of the reference reaches; counted as
    ``chai_fused_decode[kv=i8s/<V>]``)."""
    if kind == "paged":
        args = (t["q"], t["k_pool"], t["bt_k"], t["v_pool"], t["bt_v"],
                t["h2c"], t["pos"])
        return (lambda: kops.paged_chai_three_kernel_decode(
                    *args, reps_per_group=rpg),
                lambda: ck.paged_chai_fused_decode(*args,
                                                   reps_per_group=rpg),
                "paged_chai_fused_decode")
    ts = t["kw"]["ts"]
    args = (t["q"], t["k"], t["v"], t["h2c"], t["pos"])
    if t["kw"].get("share_values"):
        kw = dict(k_scale=t["kw"].get("k_scale"),
                  v_scale=t["kw"].get("v_scale"), share_values=True,
                  reps_per_group=rpg, ts=ts)
        return (lambda: kops.chai_three_kernel_decode(*args, **kw),
                lambda: ck.chai_fused_decode(*args, **kw),
                "chai_fused_decode")
    if not int8:
        return (lambda: kops.chai_three_kernel_decode(
                    *args, reps_per_group=rpg, ts=ts),
                lambda: ck.chai_fused_decode(*args, reps_per_group=rpg,
                                             ts=ts),
                "chai_fused_decode")
    kq, ks = chai_cache.quant_rows(t["k"])
    args = (t["q"], kq, t["v"], t["h2c"], t["pos"])
    return (lambda: kops.chai_three_kernel_decode(
                *args, k_scale=ks, reps_per_group=rpg, ts=ts),
            lambda: ck.chai_fused_decode(*args, k_scale=ks,
                                         reps_per_group=rpg, ts=ts),
            "chai_fused_decode")


def device_profile(fn, reps=20, tries=3):
    """{CUDA kernel: device ms per call of ``fn``} from a
    ``torch.profiler`` trace of ``reps`` calls (up to ``tries`` traces,
    as in ``device_ms``; empty when none holds device time)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total:
                out[e.key] = (out.get(e.key, 0.0)
                              + e.device_time_total / reps / 1e3)
        if out:
            break
    return out


def pipeline_lane(inputs):
    """The fused-vs-pipeline lane (phase 10) on each (label, kind,
    tensors, reps_per_group, int8) input: the pipeline driver (exactly 3
    launches) and the fused kernel (exactly 1) on the same inputs, with
    every count set to 0 just before each call and read just after; the
    pipeline's output held to the fused one's at 1e-4 (two summation
    orders, each held to the plain version at 2e-5 in phase 3); each
    kernel's profiled device time, back-to-back and single-call times of
    both, and ``decode_hbm_bytes_estimate`` of both. Returns (the lane's
    launches, its records)."""
    lane = {name: 0 for name in _launches()}
    records = []
    for label, kind, t, rpg, int8 in inputs:
        pipe, fused, fused_name = lane_calls(kind, t, rpg, int8)
        torch.cuda.synchronize()
        _reset_launches()
        out_p = pipe()
        n_pipe = _launches()
        _reset_launches()
        out_f = fused()
        n_fused = _launches()
        torch.cuda.synchronize()
        want_f = kops.decode_launch_count(fused=True) if fused_name else 0
        if (sum(n_pipe.values()) != kops.decode_launch_count(fused=False)
                or sum(n_fused.values()) != want_f):
            raise AssertionError(f"lane {label}: pipeline launches {n_pipe},"
                                 f" fused launches {n_fused}")
        for name in lane:
            lane[name] += n_pipe[name] + n_fused[name]
        err = _hold(out_p, out_f, dict(atol=1e-4, rtol=1e-4))
        share = bool(t["kw"].get("share_values"))
        b, r, hd = t["q"].shape
        h = t["h2c"].shape[-1]
        if kind == "paged":
            s = t["bt_k"].shape[1] * t["k_pool"].shape[2]
            cache = t["k_pool"].element_size()
        else:
            s, cache = t["k"].shape[2], (1 if int8 else t["k"].element_size())
        prof = device_profile(pipe)
        stages = {func: sum(ms for key, ms in prof.items()
                            if re.search(rf"\b{func}\b", key))
                  for func in ("qk_kernel", "row_softmax_kernel",
                               "av_kernel")}
        rec = dict(
            case=label, kind=kind, q=list(t["q"].shape), rpg=rpg, int8=int8,
            share_values=share,
            dtype=str((t["k_pool"] if kind == "paged" else t["k"]).dtype),
            pos=t["pos"].tolist(),
            launches_pipeline={k: v for k, v in n_pipe.items() if v},
            launches_fused={k: v for k, v in n_fused.items() if v},
            pipeline_vs_fused_max_abs_diff=err,
            pipeline_ms=time_ms(pipe), fused_ms=time_ms(fused),
            pipeline_single_call_ms=single_call_ms(pipe),
            fused_single_call_ms=single_call_ms(fused),
            pipeline_device_ms_by_stage=stages,
            pipeline_device_ms_three_kernels=sum(stages.values()),
            pipeline_device_ms_all=sum(prof.values()),
            fused_device_ms=(device_ms(fused, f"{fused_name}_kernel")
                             if fused_name else None),
            hbm_bytes_estimate={
                "pipeline": kops.decode_hbm_bytes_estimate(
                    b, h, r, s, hd, cache_bytes=cache, share_values=share,
                    fused=False),
                "fused": kops.decode_hbm_bytes_estimate(
                    b, h, r, s, hd, cache_bytes=cache, share_values=share,
                    fused=True)})
        if fused_name:
            h2c = t["h2c"]
            if h2c.ndim == 1:
                h2c = h2c.expand(b, h)
            kv = ((t["k_pool"], t["v_pool"]) if kind == "paged"
                  else (t["k"], t["v"]))
            tables = (t["bt_k"], t["bt_v"]) if kind == "paged" else ()
            flags = {}
            if int8 and not share:   # int8 K codes with scales, float V
                kv = (chai_cache.quant_rows(t["k"])[0], t["v"])
                flags = dict(k_scaled=True, v_scaled=False)
            bound, _ = fused_decode_bound(t["q"], *kv, h2c, t["pos"], rpg,
                                          tables=tables, share=share,
                                          **flags)
            rec.update(fused_bound_ms=bound)
            if rec["fused_device_ms"]:
                rec.update(
                    fused_over_pipeline_device=(
                        rec["fused_device_ms"]
                        / rec["pipeline_device_ms_three_kernels"]),
                    fused_over_bound=rec["fused_device_ms"] / bound)
                log(f"lane {label}: fused device "
                    f"{rec['fused_device_ms']:.4f} ms = "
                    f"{rec['fused_over_pipeline_device']:.3f} x the "
                    f"pipeline's three kernels "
                    f"({rec['pipeline_device_ms_three_kernels']:.4f} ms), "
                    f"{rec['fused_over_bound']:.1f} x its bound "
                    f"({bound:.4f} ms)")
        records.append(rec)
        log(f"lane {label} ({kind}, q {tuple(t['q'].shape)}, rpg {rpg}, "
            f"int8 {int8}): launches pipeline {rec['launches_pipeline']} "
            f"fused {rec['launches_fused']}; pipeline vs fused max abs diff "
            f"{err:.3e}; pipeline {rec['pipeline_ms']:.4f} ms back to back, "
            f"{rec['pipeline_single_call_ms']:.4f} single call, device "
            f"{rec['pipeline_device_ms_three_kernels']:.4f} (by stage "
            f"{ {k: round(v, 4) for k, v in stages.items()} }, all kernels "
            f"{rec['pipeline_device_ms_all']:.4f}); fused "
            f"{rec['fused_ms']:.4f} ms back to back, "
            f"{rec['fused_single_call_ms']:.4f} single call, device "
            f"{rec['fused_device_ms']}; HBM bytes estimate "
            f"{rec['hbm_bytes_estimate']}")
    return lane, records


def share_int8_av_cases(t):
    """The AV pair on the share_values int8 lane's input (phase 12's int8
    dense run, first all-STEADY step, layer 0), as the pipeline driver
    runs it: A from ``chai_qk_i8`` and ``row_softmax`` over the captured
    K codes and scales, V the captured clustered codes (R rows, no
    scales), h2c the identity (AV per rep row). ``chai_av`` at ts = PAGE
    and ``paged_chai_av`` on pages holding the same V, each against its
    plain version (over the codes' range), twice and paged == dense
    bitwise, with profiled, single-call and L2-cold device times. Returns
    {kernel: case}."""
    q, k, v, pos = t["q"], t["k"], t["v"], t["pos"]
    a = ck.row_softmax(ck.chai_qk_i8(q, k, t["kw"]["k_scale"], pos,
                                     ts=PAGE))
    idx = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)
    pool, bt = to_pages(torch.Generator("cuda").manual_seed(12), v)
    extra = dict(a=list(a.shape), v=list(v.shape), v_dtype=str(v.dtype),
                 pos=pos.tolist())
    rec, dense = stage_case(
        "chai_av", lambda: ck.chai_av(a, v, idx, ts=PAGE),
        lambda: kref.chai_av_ref(a, v, idx), av_bound(a, v, idx), codes=True,
        profile=True, cold=True)
    prec, _ = stage_case(
        "paged_chai_av", lambda: ck.paged_chai_av(a, pool, bt, idx),
        lambda: kref.paged_chai_av_ref(a, pool, bt, idx),
        av_bound(a, pool, idx, tables=(bt,)), codes=True, dense=dense,
        profile=True, cold=True)
    out = {}
    for name, r in (("chai_av", rec), ("paged_chai_av", prec)):
        out[name] = dict(case="share_int8_dense_first_steady_layer0",
                         **extra, **r)
        _log_stage(f"{name}[int8]", out[name])
    return out


# ----------------------------------------------------------- phase 13 ----
# h2o-danube-1.8b: a max_seq and prompts such that one prompt (5000) is
# longer than the 4096-token window (its ring wraps in the prefill) and
# the cohort's power-of-two bucket (8192) exceeds that prompt. The first
# four requests are the cohort's; all six go through the continuous
# engine (its 4 slots then run mixed steps).
DANUBE_MAX_SEQ = 8192
DANUBE_PROMPTS = (5000, 1200, 3000, 700)
DANUBE_CONT = ((5000, 1200, 3000, 700, 4500, 300), (32, 48) * 3)


def _check_caps(cfg, caps, label, dtypes=None):
    """Every fused decode call in the config's softcap mode and, with
    ``dtypes`` (calls by (op, K dtype)), on the config's cache dtype:
    int8 codes under ``kv_cache_dtype="int8"`` (the int8 x softcap mode),
    else the model dtype."""
    want = float(cfg.attn_logit_softcap)
    if any(cap != want for (op, cap) in caps if op != "relay"):
        raise AssertionError(f"{label}: fused calls by (op, softcap) {caps}, "
                             f"expected softcap={want}")
    dt = "int8" if tfm.kv_int8(cfg) else cfg.dtype
    if dtypes is not None and any(d != dt for (op, d) in dtypes
                                  if op != "relay"):
        raise AssertionError(f"{label}: fused calls by (op, K dtype) "
                             f"{dtypes}, expected {dt}")


def serve_local(cfg, params, use_chai, prompts, max_seq, idents=None):
    """``serve`` with each cohort row's top-2 margin behind every greedy
    token recorded ({row (= uid): [margins]}) and, with ``idents`` (a
    dict), each request's membership kept (uid: its row of the ctx).
    Returns (engine, done, wall, phases, margins)."""
    margins = {}

    def hook(eng):
        argmax = eng._argmax

        def rec(logits):
            top2 = logits.float().topk(2, dim=-1).values
            for i, gap in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
                margins.setdefault(i, []).append(gap)
            return argmax(logits)
        eng._argmax = rec
        if idents is not None and hasattr(eng, "_identify"):
            own = eng._identify

            def identify(sc):
                out = own(sc)
                for i in range(len(prompts)):
                    idents[i] = {k: v[:, i:i + 1].clone()
                                 for k, v in out.items()}
                return out
            eng._identify = identify
    eng, done, wall, phases = serve(cfg, params, use_chai, prompts, max_seq,
                                    hook)
    return eng, done, wall, phases, margins


def local_mha_want(cfg, layout, steps, launched):
    """The launches and eager decode-attention calls of ``steps`` MHA
    baseline decode steps of a model with local layers: the global layers
    take the layout's flash decode kernel (``flash_decode`` on the dense
    and cohort layouts, ``paged_decode`` on the paged one) unless the
    config caps its scores (the flash decode kernels have no softcap, as
    the Pallas ones), every other attention layer the eager attention over
    its ring (a recurrent layer calls neither). ``launched``: the run's
    counts (their keys). Returns (launches, eager calls)."""
    flash = bool(cfg.n_global_layers) and not cfg.attn_logit_softcap
    want = {name: 0 for name in launched}
    if flash:
        want["paged_decode" if layout == "paged" else "flash_decode"] = (
            cfg.n_global_layers * steps)
    return want, (cfg.n_local_layers if flash
                  else cfg.n_attn_layers) * steps


def _check_wide(cfg, launches, label, run=-1):
    """On a head dim of 320 every launch of a decode kernel the run made
    counts in the ``wide`` mode (the run's launches by mode, filed in
    MODE_RUNS at index ``run``); on any other head dim none does."""
    modes = MODE_RUNS[run]
    wide = {k.split("[")[0]: n for k, n in modes.items() if "wide" in k}
    want = ({k: n for k, n in launches.items() if n and "decode" in k
             and k != "relay_prefix_decode"}
            if cfg.head_dim == ck.WIDE_HD else {})
    if wide != want:
        raise AssertionError(f"{label}: launches in the wide mode {wide}, "
                             f"expected {want}")


def local_cohort(cfg, params, label, prompts=PROMPT_LENS, max_seq=MAX_SEQ):
    """The cohort on a local-layer model (phase 5's traffic, or
    ``prompts``), CHAI then CHAI off: the CHAI run launches
    ``chai_fused_decode`` once per global layer and STEADY step, every
    call in the config's softcap mode, and nothing else (local layers
    decode eagerly over their rings); WARMUP takes the eager attention on
    every attention layer. The MHA baseline (``local_mha_want``) launches
    ``flash_decode`` once per global layer and step unless the config
    caps its scores, and runs every other layer eagerly (the flash
    decode kernels have no softcap and no ring). Returns ({path:
    launches}, the CHAI run's summary with its tokens, margins and
    membership)."""
    cap = _Capture()
    idents = {}
    chai_core.kops = cap
    try:
        _reset_launches()
        EAGER["calls"] = 0
        eng, done, wall, phases, margins = serve_local(
            cfg, params, True, prompts, max_seq, idents)
        launches = _launches()
        chai_eager = EAGER["calls"]
    finally:
        chai_core.kops = kops
    counts = [len(r.generated) for r in done]
    if counts != [MAX_NEW] * len(prompts) or not all(
            0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError(f"{label}: token counts {counts}")
    warm = cfg.chai.warmup_tokens
    want = {name: 0 for name in launches}
    if cfg.n_global_layers:
        want["chai_fused_decode"] = ((MAX_NEW - 1 - warm)
                                     * cfg.n_global_layers)
    if launches != want or chai_eager != warm * cfg.n_attn_layers:
        raise AssertionError(f"{label}: launches {launches}, expected {want};"
                             f" eager calls {chai_eager}, expected "
                             f"{warm * cfg.n_attn_layers}")
    _check_caps(cfg, cap.caps, label, cap.dtypes)
    _check_wide(cfg, launches, label)
    n_tok = sum(counts)
    log(f"{label}: served {len(done)} requests (prompts {prompts}, bucket "
        f"{eng._prompt_bucket(max(prompts), max_seq)}, {MAX_NEW} new tokens "
        f"each) in {wall:.3f} s: {n_tok / wall:.1f} tok/s, TTFT "
        f"{[round(r.ttft, 4) for r in done]} s, decode steps "
        f"{eng.steps_executed}, launches {launches} (calls by (op, softcap) "
        f"{cap.caps}, by (op, K dtype) {cap.dtypes}), eager attention calls "
        f"{chai_eager} (WARMUP)")
    log(f"{label} CHAI run by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items()))
    _reset_launches()
    EAGER["calls"] = 0
    m_eng, _, m_wall, m_phases, _ = serve_local(cfg, params, False, prompts,
                                                max_seq)
    m_launches = _launches()
    steps = m_eng.steps_executed
    m_want, m_eager = local_mha_want(cfg, "cohort", steps, m_launches)
    if m_launches != m_want or EAGER["calls"] != m_eager:
        raise AssertionError(f"{label} MHA baseline: launches {m_launches}, "
                             f"expected {m_want}; eager calls "
                             f"{EAGER['calls']}, expected {m_eager}")
    _check_wide(cfg, m_launches, f"{label} MHA baseline")
    log(f"{label} MHA baseline: {steps} decode steps, launches "
        f"{ {k: n for k, n in m_launches.items() if n} }, "
        f"{EAGER['calls']} eager attention calls (the local layers, and "
        f"the global ones under a softcap: the flash decode kernels take "
        f"no softcap and no ring); "
        f"{n_tok / m_wall:.1f} tok/s in {m_wall:.3f} s (CHAI run "
        f"{n_tok / wall:.1f} tok/s in {wall:.3f} s); by phase "
        + ", ".join(f"{k} {v:.4f}" for k, v in m_phases.items()))
    summary = dict(wall_s=wall, tok_s=n_tok / wall,
                   ttft_mean_s=statistics.mean(r.ttft for r in done),
                   phase_s=phases, mha_wall_s=m_wall,
                   mha_tok_s=n_tok / m_wall,
                   tokens={r.uid: r.generated for r in done},
                   margins=margins, membership=idents)
    return {label: launches, f"{label}_mha": m_launches}, summary


def _check_local_kv_bytes(cfg, run, layout):
    """``kv_bytes()`` at every record of a paged run: its dense pages in
    use times a page's bytes plus every slot's rings (the reference's
    ``paged_kv_bytes``: nG x KV x page x row bytes a page, a row hd x 2 B
    in bf16, or hd codes and a 4 B scale under int8; 2 x nL x slots x KV
    x min(window, max_seq) x hd x 2 B of bf16 rings, never quantized);
    the unified layout's: the dense rectangles and the rings."""
    eng, hd, kv = run["eng"], cfg.head_dim, cfg.n_kv_heads
    ring = (2 * cfg.n_local_layers * SLOTS * kv
            * min(cfg.window_size, eng.ecfg.max_seq) * hd * 2)
    row = hd + 4 if tfm.kv_int8(cfg) else hd * 2
    if layout == "paged":
        page_bytes = cfg.n_global_layers * kv * PAGE * row
        bad = [h for h in eng.kv_bytes_history
               if h["kv_bytes"] != h["dense_pages"] * page_bytes + ring]
        if bad or not eng.kv_bytes_history:
            raise AssertionError(f"{cfg.name} paged: kv_bytes records off "
                                 f"the formula: {bad[:3]}")
        log(f"{cfg.name} paged kv_bytes = pages x {page_bytes:,} B + rings "
            f"{ring:,} B on all {len(eng.kv_bytes_history)} records; peak "
            f"{eng.kv_bytes_peak():,}, capacity {eng.kv_bytes_capacity():,}")
    else:
        dense = 2 * cfg.n_global_layers * SLOTS * kv * eng.ecfg.max_seq * row
        if eng.kv_bytes() != dense + ring:
            raise AssertionError(f"{cfg.name} dense: kv_bytes "
                                 f"{eng.kv_bytes():,} != {dense + ring:,}")
        log(f"{cfg.name} unified layout kv_bytes {eng.kv_bytes():,} = "
            f"rectangles {dense:,} + rings {ring:,}")


def gemma2_path(cfg, params, label="gemma2", mha_depth=SIDE_DEPTH,
                traffic=(CONT_PROMPT_LENS, CONT_MAX_NEW)):
    """A full-width model with local and global layers: gemma2-9b (phase
    13; phase 14 under int8) or gemma3-4b (phase 21a): the cohort on
    phase 5's traffic and the continuous engine on phase 6's, paged then
    dense, each CHAI run followed by its MHA baseline (on the first
    ``mha_depth`` layers; None: every layer); ``traffic``: the continuous
    runs' (prompt lengths, new tokens). The fused kernels run on
    the global layers only (gemma2's in the softcap mode, under int8
    the int8 x softcap mode; gemma3's 5 at head dim 320, their wide-head
    mode): each CHAI run launches its layout's kernel once per global
    layer a step with a STEADY slot and nothing else; the MHA baselines
    as ``local_mha_want`` says; paged == dense tokens; ``kv_bytes()`` on
    the formula with the rings; KV bytes unchanged at CLUSTER (GQA);
    empty pools; and both kernels held at 2e-5 against their plain
    versions on the first all-STEADY step's layer-0 global tensors, with
    device, back-to-back and single times and the bound; where the
    baselines launch the flash decode pair, both held likewise on the
    first full decode step's first global layer. Returns ({path:
    launches}, {kernel: main case}, {path: summary})."""
    _, r_max = clustering.chai_widths(cfg)
    ng = cfg.n_global_layers
    launches, cohort_sum = local_cohort(cfg, params, f"{label}_cohort")
    runs = {}
    for layout in ("paged", "dense"):
        name = f"{label} {layout}"
        run = serve_continuous(cfg, params, layout, traffic=traffic)
        calls = run["calls"]
        _check_served(cfg, run, name)
        _check_caps(cfg, run["caps"], name, run["dtypes"])
        own, op = (("paged_chai_fused_decode", "paged") if layout == "paged"
                   else ("chai_fused_decode", "dense"))
        want = {k: 0 for k in run["launches"]}
        want[own] = ng * (calls["mixed_step"] + calls["steady_step"])
        if run["launches"] != want:
            raise AssertionError(f"{name}: launches {run['launches']}, "
                                 f"expected {want} ({ng} a step with a "
                                 "STEADY slot)")
        _check_wide(cfg, run["launches"], name)
        rpg = run["capture"][op, "steady"]["kw"].get("reps_per_group")
        if rpg != r_max:
            raise AssertionError(f"{name}: reps_per_group {rpg}")
        _log_served(run, name)
        log(f"{name}: fused calls by (op, softcap) {run['caps']}, by (op, "
            f"K dtype) {run['dtypes']}")
        _check_local_kv_bytes(cfg, run, layout)
        if layout == "paged":
            _check_gqa_kv_bytes(run, name)
        run.pop("eng")
        run.pop("prefill")
        runs[layout] = run
        launches[f"{label}_continuous_{layout}"] = run["launches"]
        torch.cuda.empty_cache()
        EAGER["calls"] = 0
        m_cfg, m_params = ((cfg, params) if mha_depth is None
                           else cut_depth(cfg, params, mha_depth))
        m_run = serve_continuous(m_cfg, m_params, layout, use_chai=False,
                                 traffic=traffic)
        m_calls = m_run["calls"].get("mha_step", 0)
        m_want, m_eager = local_mha_want(m_cfg, layout, m_calls,
                                         m_run["launches"])
        if (m_run["launches"] != m_want or EAGER["calls"] != m_eager
                or not m_calls):
            raise AssertionError(f"{name} MHA baseline: launches "
                                 f"{m_run['launches']}, expected {m_want}; "
                                 f"eager calls {EAGER['calls']}, expected "
                                 f"{m_eager}")
        _check_wide(m_cfg, m_run["launches"], f"{name} MHA baseline")
        if m_run["eng"].paged and m_run["eng"].dense_pool.pages_in_use:
            raise AssertionError(f"{name} MHA baseline: pages left in use")
        _log_served(m_run, f"{name} MHA baseline")
        log(f"{name} MHA baseline ({m_cfg.n_layers} layers): launches "
            f"{ {k: n for k, n in m_run['launches'].items() if n} }, "
            f"{EAGER['calls']} eager attention calls")
        m_run.pop("eng")
        runs[f"mha_{layout}"] = m_run
        launches[f"{label}_mha_{layout}"] = m_run["launches"]
        torch.cuda.empty_cache()
    for kind in ("", "mha_"):
        if ([r.generated for r in runs[f"{kind}paged"]["done"]]
                != [r.generated for r in runs[f"{kind}dense"]["done"]]):
            raise AssertionError(f"{label} {kind or 'chai '}: paged and "
                                 "dense gave different greedy tokens")
    pc = runs["paged"]["capture"]["paged", "steady"]
    dc = runs["dense"]["capture"]["dense", "steady"]
    live = pc["note"] != chai_cache.PHASE_FREE
    p_out = ck.paged_chai_fused_decode(
        pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
        pc["h2c"], pc["pos"], **pc["kw"])
    d_out = ck.chai_fused_decode(dc["q"], dc["k"], dc["v"], dc["h2c"],
                                 dc["pos"], **dc["kw"])
    torch.cuda.synchronize()
    if not torch.equal(p_out[live], d_out[live]):
        raise AssertionError(f"{label}: paged vs dense kernel on the first "
                             "all-STEADY step differ")
    cases = first_steady_cases(label, pc, dc)
    mp = runs["mha_paged"].pop("prefill").get(("paged_decode", SLOTS))
    md = runs["mha_dense"].pop("prefill").get(("flash_decode", SLOTS))
    if md is not None:
        pa = (mp["q"], mp["pool"], mp["bt_k"], mp["bt_v"], mp["pos"])
        da = (md["q"], md["k"], md["v"], md["pos"])
        ts = int(md["ts"])
        for name, args, kw in (("flash_decode", da,
                                dict(ts=ts, library=True)),
                               ("paged_decode", pa, {})):
            rec, _ = flash_decode_case(name, args, profile=True, **kw)
            cases[name] = dict(case=f"{label}_mha_first_full_step_global",
                               **rec)
            _log_flash_decode(name, cases[name])
        _bitwise(f"{label}: paged_decode vs flash_decode on the first full "
                 "step", fk.paged_decode(*pa), fk.flash_decode(*da, ts=ts))
    summaries = {k: _run_summary(v) for k, v in runs.items()}
    summaries["cohort"] = {k: v for k, v in cohort_sum.items()
                           if k not in ("membership", "margins")}
    return launches, cases, summaries


def gemma2_int8_path(cfg8, params, bf16_launches, bf16_sums):
    """Phase 14: gemma2-9b with ``kv_cache_dtype="int8"`` on phase 13's
    weights and traffic (``gemma2_path``): the same number of fused-pair
    launches as the bf16 run of phase 13 on every path (``bf16_launches``),
    all in the int8 x softcap mode; wall, tok/s, step ms and the device
    memory peak logged beside the bf16 run's (``bf16_sums``). Returns
    ``gemma2_path``'s triple."""
    launches, cases, sums = gemma2_path(cfg8, params, label="gemma2_int8")
    for path, counts in launches.items():
        twin = bf16_launches[path.replace("gemma2_int8", "gemma2")]
        if counts != twin:
            raise AssertionError(f"{path}: launches {counts} against the "
                                 f"bf16 run's {twin}")
    for key, mine in sums.items():
        theirs = bf16_sums[key]
        log(f"gemma2 int8 {key} against bf16: wall {mine['wall_s']:.3f} s "
            f"({theirs['wall_s']:.3f}), {mine['tok_s']:.1f} tok/s "
            f"({theirs['tok_s']:.1f}), TTFT mean {mine['ttft_mean_s']:.4f} "
            f"s ({theirs['ttft_mean_s']:.4f})"
            + (f", step ms {mine['step_ms']} ({theirs['step_ms']}), device "
               f"memory peak above the run's start "
               f"{mine['device_peak_run']:,} B "
               f"({theirs['device_peak_run']:,})" if "step_ms" in mine
               else f", MHA baseline {mine['mha_tok_s']:.1f} tok/s "
                    f"({theirs['mha_tok_s']:.1f})"))
    return launches, cases, sums


class _PrefillModes:
    """Stands in for ``kernels.ops`` inside ``models.transformer`` and
    counts the prefill ops' calls by (op, softcap, pool dtype); with
    ``plain`` each call takes the op's plain version instead of its
    kernel (on the same CUDA tensors)."""

    def __init__(self, plain=False):
        self.calls, self.plain = {}, plain

    def _count(self, op, cap, dtype):
        key = (op, float(cap), str(dtype).replace("torch.", ""))
        self.calls[key] = self.calls.get(key, 0) + 1

    def paged_prefix_attention(self, q, kv_pool, bt_k, bt_v, plen, **kw):
        self._count("paged_prefix_attend", kw.get("softcap", 0.0),
                    kv_pool.dtype)
        if self.plain:
            return kref.paged_prefix_attend_ref(q, kv_pool, bt_k, bt_v,
                                                plen, **kw)
        return kops.paged_prefix_attention(q, kv_pool, bt_k, bt_v, plen,
                                           **kw)

    def flash_prefill_attention(self, q, k, v, offset=0, **kw):
        self._count("flash_prefill", kw.get("softcap", 0.0), k.dtype)
        if self.plain:
            emit = kw.pop("emit_state", False)
            fn = (kref.flash_prefill_state_ref if emit
                  else kref.flash_prefill_ref)
            return fn(q, k, v, offset=offset, **kw)
        return kops.flash_prefill_attention(q, k, v, offset, **kw)

    merge_prefill_states = staticmethod(kops.merge_prefill_states)
    finalize_prefill_state = staticmethod(kops.finalize_prefill_state)


def gemma2_suffix_prefill_path(cfg, params, label):
    """gemma2-9b's model-level suffix prefill at full depth and width
    (``models.transformer.forward_fullseq(prefix_len, prefix_kv)``, the
    reference's suffix prefill; the engines refuse the prefix cache on a
    local arch, as the reference's do): a 256-token prefix prefilled into
    a dense state (eager attention, no launch), its global K/V (under
    int8: codes and scales) moved to shuffled pool pages, then a
    128-token suffix over them. Every global layer merges
    ``paged_prefix_attend`` over the pages with ``flash_prefill`` over
    the suffix, both in the softcap mode (the pool int8 under int8): a
    launch of each a global layer and nothing else. The logits are
    finite and hold
    the plain route's (the same call with every prefill op on its plain
    version) greedy token on every position whose plain top-2 margin
    exceeds CHUNK_MARGIN (bf16 activations round apart between the two
    routes). Returns ({path: launches}, a summary)."""
    int8 = tfm.kv_int8(cfg)
    plen, t = SYS_LEN, CHUNK
    ng, kv, hd = cfg.n_global_layers, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, plen + t))).cuda()
    st = tfm.init_decode_state(cfg, 1, plen + t, "cuda")
    _reset_launches()
    _, st = tfm.forward_fullseq(params, cfg, toks[:, :plen], state=st)
    if any(_launches().values()):
        raise AssertionError(f"{label}: the prefix prefill launched "
                             f"{_launches()}")
    n_pages = plen // PAGE
    n_pool = 2 * n_pages + 1
    gen = torch.Generator("cuda").manual_seed(31)
    ids = (torch.randperm(n_pool - 1, generator=gen, device="cuda")
           + 1).to(torch.int32)
    bt_k, bt_v = ids[:n_pages][None], ids[n_pages:2 * n_pages][None]
    pool = torch.zeros((ng, n_pool, kv, PAGE, hd), dtype=st["kg"].dtype,
                       device="cuda")
    prefix = {"pool": pool, "bt_k": bt_k, "bt_v": bt_v}
    if int8:
        prefix["scale"] = torch.zeros((ng, n_pool, kv, PAGE), device="cuda")
    for name, bt in (("kg", bt_k), ("vg", bt_v)):
        x = st[name][:, 0, :, :plen].reshape(ng, kv, n_pages, PAGE, hd)
        pool[:, bt[0].long()] = x.permute(0, 2, 1, 3, 4)
        if int8:
            sc = st[name + "_scale"][:, 0, :, :plen].reshape(
                ng, kv, n_pages, PAGE)
            prefix["scale"][:, bt[0].long()] = sc.permute(0, 2, 1, 3)
    del st
    out = {}
    for route in ("kernels", "plain"):
        modes = _PrefillModes(plain=route == "plain")
        st = tfm.init_decode_state(cfg, 1, plen + t, "cuda")
        tfm.kops = modes
        try:
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, st = tfm.forward_fullseq(params, cfg, toks[:, plen:],
                                             state=st, prefix_len=plen,
                                             prefix_kv=prefix)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
        finally:
            tfm.kops = kops
        out[route] = (logits.float(), launches, modes.calls, wall,
                      int(st["pos"][0]))
        del st
    logits, launches, calls, wall, pos = out["kernels"]
    plain, _, plain_calls, plain_wall, _ = out["plain"]
    want = {k: 0 for k in launches}
    want["flash_prefill"] = want["paged_prefix_attend"] = ng
    dt = "int8" if int8 else cfg.dtype
    want_calls = {("flash_prefill", cfg.attn_logit_softcap, cfg.dtype): ng,
                  ("paged_prefix_attend", cfg.attn_logit_softcap, dt): ng}
    if (launches != want or calls != want_calls or plain_calls != want_calls
            or pos != plen + t):
        raise AssertionError(f"{label}: launches {launches} (expected "
                             f"{want}), calls {calls} (expected "
                             f"{want_calls}), pos {pos}")
    if (logits.shape != (1, t, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)} not "
                             "finite or misshapen")
    top2 = plain[0].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    sure = margin > CHUNK_MARGIN
    same = logits[0].argmax(-1) == plain[0].argmax(-1)
    if not same[sure].all():
        raise AssertionError(f"{label}: the kernels' greedy token differs "
                             "from the plain route's at a margin > "
                             f"{CHUNK_MARGIN}")
    diff = float((logits - plain).abs().max())
    log(f"{label}: forward_fullseq over a {plen}-token prefix in pages "
        f"({dt}) and a {t}-token suffix: launches {launches}, prefill op "
        f"calls by (op, softcap, dtype) {calls}; {wall * 1e3:.2f} ms "
        f"(plain route {plain_wall * 1e3:.2f} ms); greedy tokens equal to "
        f"the plain route's on {int(same.sum())} of {t} positions, all "
        f"{int(sure.sum())} with a margin > {CHUNK_MARGIN}; logits max abs "
        f"diff {diff:.3e}")
    return {label: launches}, dict(wall_ms=wall * 1e3,
                                   plain_wall_ms=plain_wall * 1e3,
                                   same_greedy=int(same.sum()),
                                   positions=t, logits_max_abs_diff=diff)


def danube_path(cfg, params):
    """Full-width h2o-danube-1.8b (phase 13; every layer local, window
    4096): the cohort on DANUBE_PROMPTS in a max_seq of 8192 (bucket 8192
    > the 5000-token prompt > the window), then the default continuous
    engine (kv_layout "paged", which for a model without global layers
    is the unified layout, as in the reference) on DANUBE_CONT, each
    request the cohort served clustered through the cohort's membership.
    No kernel launches (no global layer). The two schedulers' greedy
    tokens are held equal up to each request's first divergence, which
    must sit on a cohort top-2 margin <= CHUNK_MARGIN. Returns ({path:
    launches}, {scheduler: summary})."""
    if not max(DANUBE_PROMPTS) > cfg.window_size:
        raise AssertionError("no prompt passes the window")
    launches, cohort = local_cohort(cfg, params, "danube_cohort",
                                    DANUBE_PROMPTS, DANUBE_MAX_SEQ)
    membership = {uid: (None, ctx, True)
                  for uid, ctx in cohort["membership"].items()}
    run = serve_continuous(cfg, params, "paged", traffic=DANUBE_CONT,
                           max_seq=DANUBE_MAX_SEQ, membership=membership)
    if run["eng"].paged:
        raise AssertionError("danube: a paged layout without global layers")
    _check_served(cfg, run, "danube continuous")
    if any(run["launches"].values()):
        raise AssertionError(f"danube continuous: launches {run['launches']}")
    _log_served(run, "danube continuous (unified layout)")
    _check_local_kv_bytes(cfg, run, "dense")
    held = compared = 0
    parted = []
    for r in run["done"]:
        if r.uid not in cohort["tokens"]:
            continue
        want, gaps = cohort["tokens"][r.uid], cohort["margins"][r.uid]
        for k, (got, tok) in enumerate(zip(r.generated, want)):
            compared += 1
            if got != tok:
                if gaps[k] > CHUNK_MARGIN:
                    raise AssertionError(
                        f"danube uid {r.uid} token {k}: continuous {got} != "
                        f"cohort {tok} at margin {gaps[k]:.4f}")
                parted.append((r.uid, k, round(gaps[k], 5)))
                break
            held += gaps[k] > CHUNK_MARGIN
    if held < compared // 2:
        raise AssertionError(f"danube: only {held} of {compared} tokens held")
    same = {uid: v[2] for uid, v in run["idents"].items()}
    log(f"danube cohort vs continuous: {held} of {compared} tokens compared "
        f"held on margins > {CHUNK_MARGIN}; first divergences (uid, token, "
        f"margin) {parted}; each request's own continuous membership equal "
        f"to the cohort's: {same}")
    launches["danube_continuous"] = run["launches"]
    summary = _run_summary(run)
    run.pop("eng")
    return launches, {"cohort": {k: v for k, v in cohort.items()
                                 if k not in ("membership", "margins")},
                      "continuous": summary}


def danube_int8_path(cfg, params, bf16_cohort):
    """Phase 14: h2o-danube-1.8b with ``kv_cache_dtype="int8"`` on phase
    13's weights and cohort traffic. It has no global layer, so nothing
    is quantized (its rings stay bf16) and nothing launches: its greedy
    tokens equal the bf16 cohort's (``bf16_cohort``) exactly. Returns
    {path: launches}."""
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    shapes = tfm.decode_state_shapes(cfg8, 1, DANUBE_MAX_SEQ)
    if any(dt == torch.int8 for _, dt in shapes.values()):
        raise AssertionError(f"danube int8: quantized state {shapes}")
    launches, cohort = local_cohort(cfg8, params, "danube_int8_cohort",
                                    DANUBE_PROMPTS, DANUBE_MAX_SEQ)
    if cohort["tokens"] != bf16_cohort["tokens"]:
        raise AssertionError("danube int8: greedy tokens differ from the "
                             "bf16 cohort's")
    log(f"danube int8 cohort: greedy tokens equal to the bf16 cohort's on "
        f"all {sum(map(len, cohort['tokens'].values()))}; "
        f"{cohort['tok_s']:.1f} tok/s (bf16 {bf16_cohort['tok_s']:.1f})")
    return launches


def densified(t):
    """A paged capture's logical K/V views (the engine's own gather)."""
    return (chai_cache.gather_pages(t["k_pool"], t["bt_k"]),
            chai_cache.gather_pages(t["v_pool"], t["bt_v"]))


# ----------------------------------------------------------- phase 15 ----
# The front door's traffic: the first four of phase 6's prompts, two
# greedy and two seeded (FRONT_SEEDS), FRONT_NEW tokens each; the rate
# runs serve the same prompts all greedy or all seeded, FRONT_RATE_NEW
# tokens each, in the turns FRONT_TURNS (a drift of the host clock falls
# on both kinds alike).
FRONT_NEW = 16
FRONT_RATE_NEW = 32
FRONT_TURNS = ("greedy", "seeded", "seeded", "greedy", "greedy", "seeded")
FRONT_SEEDS = (100, 101)
SEEDED = dict(temperature=0.8, top_k=50, top_p=0.95)


def detok(ids):
    """The space-joined-ids detokenizer."""
    return " ".join(map(str, ids))


def front_ecfg(**kw):
    return EngineConfig(**{**dict(batch_slots=SLOTS, max_seq=MAX_SEQ,
                                  page_size=PAGE, prefix_cache=True), **kw})


def front_traffic(cfg, new=FRONT_NEW, seeds=(None, None) + FRONT_SEEDS):
    """(prompts, SamplingParams): phase 6's first four prompts; a None
    seed is a greedy request."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in CONT_PROMPT_LENS[:4]]
    sps = [SamplingParams(max_new_tokens=new) if s is None else
           SamplingParams(seed=s, max_new_tokens=new, **SEEDED)
           for s in seeds]
    return prompts, sps


def _pools_empty(core, label):
    used = (core.dense_pool.pages_in_use,
            core.chai_pool.pages_in_use if core.chai_pool else 0)
    if used != (0, 0):
        raise AssertionError(f"{label}: pages in use {used}")


def _front_tokens(cfg, params, prompts, sps, **kw):
    """The traffic's tokens through a ServingEngine (``kw``:
    EngineConfig), in uid order."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE, **kw))
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        eng.submit(p, max_new_tokens=sp.max_new_tokens, uid=i, sampling=sp)
    done = sorted(eng.run(), key=lambda r: r.uid)
    if eng.paged:
        _pools_empty(eng, f"{cfg.name} {kw}")
    return [r.generated for r in done]


def _check_outputs(cfg, outs, new, label):
    """Every output ``new`` tokens long, finished on length, in the
    vocabulary."""
    got = [(len(o.token_ids), o.finish_reason) for o in outs]
    if (got != [(new, FINISH_LENGTH)] * len(outs)
            or not all(0 <= t < cfg.vocab_size
                       for o in outs for t in o.token_ids)):
        raise AssertionError(f"{label}: outputs {got}")


def front_door_path(cfg, params):
    """Phase 15 on chai-llama-7b: the front door (``serving.api``) on phase
    6's weights and engine settings. Returns ({path: launches}, the
    sampler's timing record)."""
    prompts, sps = front_traffic(cfg)
    llm = LLM(cfg, params, front_ecfg())
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches()
    _check_outputs(cfg, outs, FRONT_NEW, "LLM.generate")
    want = {name: 0 for name in launches}
    want["paged_chai_fused_decode"] = launches["paged_chai_fused_decode"]
    if launches != want or not want["paged_chai_fused_decode"] \
            or want["paged_chai_fused_decode"] % cfg.n_layers:
        raise AssertionError(f"front door launches {launches}")
    toks = [o.token_ids for o in outs]
    log(f"front door: LLM.generate of 4 requests (prompts "
        f"{CONT_PROMPT_LENS[:4]}, 2 greedy, 2 seeded {SEEDED} seeds "
        f"{FRONT_SEEDS}, {FRONT_NEW} new tokens each) in {wall:.3f} s, "
        f"launches {launches}")
    # EngineCore.add_request / step on the same requests
    core = EngineCore(cfg, params, front_ecfg())
    reqs = [core.add_request(p, sp) for p, sp in zip(prompts, sps)]
    while core.has_work():
        core.step()
    if [r.generated for r in reqs] != toks:
        raise AssertionError("LLM.generate and EngineCore.step differ")
    del core, reqs
    # a second LLM on the same weights (with the detokenizer, for the stop
    # strings below)
    llm2 = LLM(cfg, params, front_ecfg(), detokenizer=detok)
    if [o.token_ids for o in llm2.generate(prompts, sps)] != toks:
        raise AssertionError("a second LLM did not repeat the tokens")
    for kw in (dict(kv_layout="dense"), dict(scheduler="cohort")):
        if _front_tokens(cfg, params, prompts, sps, **kw) != toks:
            raise AssertionError(f"{kw}: tokens differ from the paged run's")
    log(f"front door: EngineCore.step, a second LLM, the dense layout and "
        f"the cohort repeat all {sum(map(len, toks))} tokens (greedy and "
        f"seeded); seeded tokens {toks[2:]}")
    # stop strings: the first match of the unstopped tokens
    base = toks[0]
    for lo in (3, 8):
        stop = detok(base[lo:lo + 2])
        sp = SamplingParams(max_new_tokens=FRONT_NEW, stop=(stop,))
        out = llm2.generate(prompts[0], sp)[0]
        if ((out.token_ids, out.finish_reason)
                != sampling_mod.scan_finish(base, sp, FRONT_NEW, detok)
                or out.finish_reason != "stop" or out.text
                != detok(out.token_ids)):
            raise AssertionError(f"stop {stop!r}: {out.token_ids} "
                                 f"{out.finish_reason}")
        log(f"front door: stop string {stop!r} (tokens {lo}, {lo + 1} of "
            f"the unstopped run) ends after {len(out.token_ids)} tokens, "
            f"scan_finish's first match")
    llm2.core.prefix_cache.clear()
    _pools_empty(llm2.core, "stop strings")
    del llm2
    # a stream: first chunk at admission, then abort
    rng = np.random.default_rng(15)
    t0 = time.time()
    it = llm.stream(rng.integers(0, cfg.vocab_size, size=256),
                    SamplingParams(seed=7, max_new_tokens=64, **SEEDED))
    first = next(it)
    t_first = time.time() - t0
    if first.finished or not first.token_ids or not llm.abort(first.uid):
        raise AssertionError(f"stream first chunk {first}")
    tail = list(it)
    if [(c.token_ids, c.finished, c.finish_reason) for c in tail] != \
            [([], True, "aborted")]:
        raise AssertionError(f"aborted stream's tail {tail}")
    llm.core.prefix_cache.clear()
    _pools_empty(llm.core, "stream abort")
    log(f"front door: stream of a 256-token prompt: first chunk "
        f"{first.token_ids} at {t_first:.4f} s host time (admission), "
        f"aborted after it: one empty 'aborted' chunk, both pools at 0 "
        f"pages after clearing the prefix cache")
    # a 3-turn session over the prefix cache
    ses = Session(llm, SamplingParams(max_new_tokens=8))
    turns = []
    for n in (64, 16, 16):
        out = ses.send(rng.integers(0, cfg.vocab_size, size=n))
        turns.append((len(out.prompt_token_ids), out.cached_tokens,
                      out.prefill_tokens))
    if not all(c > 0 and f < p for p, c, f in turns[1:]):
        raise AssertionError(f"session turns (prompt, cached, prefilled) "
                             f"{turns}")
    llm.core.prefix_cache.clear()
    _pools_empty(llm.core, "session")
    log(f"front door: 3-turn Session (prompt, cached, prefilled): {turns}")
    del llm
    side_cfg, side_params = cut_depth(cfg, params)
    llm = LLM(side_cfg, side_params, front_ecfg())
    rates, sample = front_rates(side_cfg, llm)
    del llm
    return {"front_door_paged": launches}, {"rates": rates, **sample}


class _Split(list):
    """The decode steps' records of ``_step_split``, and the garbage
    collections since the last ``clear``."""
    collections = 0

    def clear(self):
        super().clear()
        self.collections = 0


def _step_split(core):
    """Split each decode step of ``core`` into its forward (the dispatch of
    the batched decode) and its pick (argmax or the sampler): host time
    (perf_counter) and device span (between CUDA events) of each, and the
    step's wall. Returns (the records, a dict a step; a function that
    unwraps the engine)."""
    split, cur = _Split(), {}
    names = ("step", "_dispatch_decode", "_argmax", "_sampler")
    saved = {n: vars(core)[n] for n in names if n in vars(core)}
    step, dispatch = core.step, core._dispatch_decode
    argmax, sampler = core._argmax, core._sampler

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        cur[name] = (time.perf_counter(), ev)

    def timed_dispatch(*args):
        cur.pop("end", None)        # a prefill's pick came before
        mark("fwd")
        out = dispatch(*args)
        mark("pick")
        return out

    def timed(pick):
        def inner(*args):
            out = pick(*args)
            mark("end")
            return out
        return inner

    def timed_step():
        cur.clear()
        t0 = time.perf_counter()
        out = step()
        if "fwd" in cur and "end" in cur:   # a decode ran, tokens read
            (t_f, e_f), (t_p, e_p), (t_e, e_e) = (
                cur[k] for k in ("fwd", "pick", "end"))
            split.append(dict(
                step=1e3 * (time.perf_counter() - t0),
                fwd_host=1e3 * (t_p - t_f), pick_host=1e3 * (t_e - t_p),
                fwd_device=e_f.elapsed_time(e_p),
                pick_device=e_p.elapsed_time(e_e)))
        return out

    def on_gc(phase, info):
        if phase == "stop":
            split.collections += 1

    def unwrap():
        gc.callbacks.remove(on_gc)
        for n in names:
            vars(core).pop(n, None)
        vars(core).update(saved)

    core.step, core._dispatch_decode = timed_step, timed_dispatch
    core._argmax, core._sampler = timed(argmax), timed(sampler)
    gc.callbacks.append(on_gc)
    return split, unwrap


def _host_ms(fn, reps=50):
    """Median host time (ms) of one call of ``fn``, each call started on
    an idle card: the time the host spends before it can go on."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def _op_counts(fn):
    """(top-level torch ops, CUDA kernels and copies) of one call of
    ``fn``, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.events()
    return (sum(e.device_type.name == "CPU" and e.cpu_parent is None
                and e.name.startswith("aten::") for e in ev),
            sum(e.device_type.name == "CUDA" for e in ev))


def sampler_host(fresh, logits, args):
    """Where the host time of one sampler call goes (``_host_ms`` each):
    the rows' noise (``gumbel_noise``), the pinned knob buffer with that
    noise (``host_knobs``), the copy's enqueue, the batched argmax, and
    the whole call, alone and with its device work finished; the rest of
    the call is the enqueue of the candidates, the pick and the
    scatter."""
    dev = logits.device
    cap = min(256, logits.shape[-1])
    temps, _, _, seed, count = args
    rows = np.flatnonzero(np.asarray(temps, np.float32) > 0.0)
    _, host = steps.host_knobs(*args, cap, pin=True)
    out = {"noise": _host_ms(lambda: steps.gumbel_noise(
               np.asarray(seed)[rows], np.asarray(count)[rows], cap)),
           "host_knobs": _host_ms(lambda: steps.host_knobs(*args, cap,
                                                           pin=True)),
           "copy": _host_ms(lambda: host.to(dev, non_blocking=True)),
           "argmax": _host_ms(lambda: torch.argmax(logits, dim=-1)),
           "call": _host_ms(lambda: fresh(logits, *args)),
           "call_synced": _host_ms(lambda: (fresh(logits, *args),
                                            torch.cuda.synchronize()))}
    out["candidates_pick_enqueue"] = (out["call"] - out["host_knobs"]
                                      - out["copy"] - out["argmax"])
    out["ops"], out["kernels"] = _op_counts(lambda: fresh(logits, *args))
    return out


def front_rates(cfg, llm):
    """tok/s and the median decode step of the traffic all greedy against
    all seeded (FRONT_RATE_NEW tokens a request, in the turns FRONT_TURNS,
    the prefix cache cleared before each run), each step split into its
    forward and its pick (``_step_split``); then the sampler on one
    all-seeded step's logits: the card's picks against the CPU's on a
    copy, its device time against argmax's, and where its host time
    goes."""
    prompts, _ = front_traffic(cfg)
    grid = {"greedy": (None,) * 4,
            "seeded": tuple(FRONT_SEEDS[0] + i for i in range(4))}
    rates = {k: [] for k in grid}
    runs = {k: [] for k in grid}
    caught = {"calls": 0}
    sampler = llm.core._sampler

    def catch(logits, *args):
        # the 8th batched call: every slot samples, all past WARMUP
        if logits.shape[0] == SLOTS and "logits" not in caught:
            caught["calls"] += 1
            if caught["calls"] == 8 and np.all(np.asarray(args[0]) > 0):
                caught["logits"] = logits.clone()
                caught["args"] = [np.array(a) for a in args]
        return sampler(logits, *args)

    llm.core._sampler = catch
    split, unwrap = _step_split(llm.core)
    for kind in FRONT_TURNS:
        _, sps = front_traffic(cfg, FRONT_RATE_NEW, grid[kind])
        llm.core.prefix_cache.clear()
        split.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        outs = llm.generate(prompts, sps)
        torch.cuda.synchronize()
        wall = time.time() - t0
        _check_outputs(cfg, outs, FRONT_RATE_NEW, f"tok/s {kind}")
        rates[kind].append(4 * FRONT_RATE_NEW / wall)
        runs[kind].append({key: statistics.median(r[key] for r in split)
                           for key in split[0]})
        runs[kind][-1]["gc"] = split.collections
    unwrap()
    llm.core._sampler = sampler
    llm.core.prefix_cache.clear()
    step_ms = {k: [r["step"] for r in v] for k, v in runs.items()}
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    spread = max(max(v) - min(v) for v in step_ms.values())
    diff = med["seeded"] - med["greedy"]
    log(f"front door, 4 requests of {FRONT_RATE_NEW} new tokens, turns "
        f"{FRONT_TURNS}: tok/s {rates}; each run's medians over its decode "
        f"steps (ms; host: perf_counter, device: the span between CUDA "
        f"events) and its garbage collections: {runs}; seeded - greedy "
        f"median step {diff:.4f} ms, against the widest spread of one "
        f"kind's runs {spread:.4f} ms: "
        + ("outside" if abs(diff) > spread else "within") + " the spread")
    logits, args = caught["logits"], caught["args"]
    fresh = steps.make_sampler()
    card = fresh(logits, *args).cpu()
    cpu = fresh(logits.cpu(), *args)
    top = logits.float().topk(min(257, logits.shape[-1]), dim=-1).values
    ties = int((top[:, 1:] == top[:, :-1]).sum())
    if not torch.equal(card, cpu):
        raise AssertionError(f"card picks {card.tolist()} against the "
                             f"CPU's {cpu.tolist()}")
    sample_ms = library_device_ms(lambda: fresh(logits, *args))
    argmax_ms = library_device_ms(lambda: torch.argmax(logits, dim=-1))
    sample_b2b = time_ms(lambda: fresh(logits, *args))
    argmax_b2b = time_ms(lambda: torch.argmax(logits, dim=-1))
    host = sampler_host(fresh, logits, args)
    # the step waits for its tokens, so the sampler's host time, less the
    # argmax it replaces, is what a sampled step adds where the host is
    # the slower side
    extra = host["call_synced"] - host["argmax"]
    log(f"a sampled step's extra host time, measured by the call: "
        f"{extra:.4f} ms, {100 * extra / med['greedy']:.2f}% of the greedy "
        f"runs' median step")
    log(f"sampler on one all-seeded step's logits {tuple(logits.shape)} "
        f"(knobs {[a.tolist() for a in args]}; {ties} exact ties between "
        f"neighbours in the rows' top 257): card picks {card.tolist()} == "
        f"CPU picks; device ms per step: sampler {sample_ms} (every kernel "
        f"and copy of one call, torch.profiler), argmax {argmax_ms}; b2b "
        f"ms sampler {sample_b2b:.4f}, argmax {argmax_b2b:.4f}; host ms "
        f"of one call (median of 50, each from an idle card) "
        f"{ {k: round(v, 4) for k, v in host.items()} }")
    return rates, {"runs": runs, "step_diff_ms": diff,
                   "step_spread_ms": spread, "sampled_extra_ms": extra,
                   "sampler_device_ms": sample_ms,
                   "argmax_device_ms": argmax_ms,
                   "sampler_b2b_ms": sample_b2b,
                   "argmax_b2b_ms": argmax_b2b, "sampler_host_ms": host}


def front_door_gqa(cfg, params):
    """Phase 15 on nemotron-4-15b: the seeded generate repeats itself on a
    second LLM, and the dense layout gives the same tokens."""
    prompts, sps = front_traffic(cfg)
    runs = []
    for _ in range(2):
        llm = LLM(cfg, params, front_ecfg())
        _reset_launches()
        outs = llm.generate(prompts, sps)
        launches = _launches()
        _check_outputs(cfg, outs, FRONT_NEW, f"{cfg.name} generate")
        llm.core.prefix_cache.clear()
        _pools_empty(llm.core, f"{cfg.name} generate")
        runs.append([o.token_ids for o in outs])
        del llm
    dense = _front_tokens(cfg, params, prompts, sps, kv_layout="dense")
    if not runs[0] == runs[1] == dense:
        raise AssertionError(f"{cfg.name}: repeat / dense tokens differ")
    if not launches["paged_chai_fused_decode"]:
        raise AssertionError(f"{cfg.name} front door launches {launches}")
    log(f"front door {cfg.name}: a second LLM and the dense layout repeat "
        f"all {sum(map(len, dense))} tokens; seeded {dense[2:]}; launches "
        f"{launches}")
    return {"nemotron_front_door_paged": launches}


# ----------------------------------------------------------- phase 16 ----
POLICY_T = 512


def offline_path(cfg, params):
    """Phase 16: the offline phase on the entry's calibration batch (16
    sequences of 24 tokens of the reference's corpus,
    ``calibration_batches``); the card's cluster counts against the CPU's
    on a copy of the same features."""
    n, seq_len = offline_clustering.N_SAMPLES, offline_clustering.SEQ_LEN
    batches = list(calibration_batches(cfg.vocab_size, seq_len, n))
    torch.cuda.synchronize()
    t0 = time.time()
    out = offline_clustering.offline_phase(
        params, cfg, batches, device=params["embed"]["tok"].device)
    wall = time.time() - t0
    t0 = time.time()
    cpu = offline_clustering.elbow_analysis(out["features"].cpu())
    cpu_wall = time.time() - t0
    if len(out["counts"]) != cfg.n_attn_layers or not np.isfinite(
            out["curves"]).all():
        raise AssertionError(f"offline counts {out['counts']}")
    tol = 0.05
    for li, (a, b) in enumerate(zip(out["counts"], cpu["counts"])):
        if a == b:
            continue
        gains = [np.diff(-c) / max(c[0] - c[-1], 1e-12)
                 for c in (out["curves"][li], cpu["curves"][li])]
        near = min(abs(g - tol).min() for g in gains)
        log(f"offline layer {li}: card k {a}, CPU k {b}; the gain nearest "
            f"plateau_tol {tol} lies {near:.3e} from it")
        if near > 1e-6:
            raise AssertionError(f"offline layer {li}: counts {a} / {b}")
    log(f"offline phase ({n} sequences of {seq_len} "
        f"tokens, features {tuple(out['features'].shape)}): {wall:.3f} s on "
        f"the card (elbow on the CPU copy {cpu_wall:.3f} s); cluster counts "
        f"{out['counts']} (CPU {cpu['counts']}; the config's frozen "
        f"{list(cfg.chai_cluster_counts())}); mean |offdiag| "
        f"{[round(x, 4) for x in out['offdiag']]}")
    return out


def policy_path(cfg, params):
    """Phase 16: the seven policies on layer-0 q, k, v of a 512-token
    prefill (fp32), the card's outputs against the CPU's."""
    dev = params["embed"]["tok"].device
    rng = np.random.default_rng(16)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(1, POLICY_T))).to(dev)
    p = tfm._layer(params["attn"], tfm.layer_plan(cfg)["attn"][0])
    with torch.no_grad():
        x = tfm.embed_lookup(params["embed"]["tok"], toks).to(
            tfm.model_dtype(cfg))
        xn = tfm.rms_norm(x, p["ln"], cfg.norm_eps)
        qkv = [t.float() for t in tfm.attn_mod.project_qkv(
            xn, p, cfg, torch.arange(POLICY_T, device=dev))]
    cpu_qkv = [t.cpu() for t in qkv]
    h = cfg.n_heads
    mha = None
    rows = []
    for name in ("mha", "chai", "chai-qkv", "chai-static", "random",
                 "dejavu", "spatten"):
        kw = {}
        if name == "chai-static":
            kw = dict(h2c_static=static["h2c"][0], reps_static=static[
                "reps"][0])
        t0 = time.time()
        card = policy.apply_policy(name, *qkv, **{
            k: v.to(dev) for k, v in kw.items()})
        torch.cuda.synchronize()
        ms = 1e3 * (time.time() - t0)
        cpu = policy.apply_policy(name, *cpu_qkv, **kw)
        if float(card.score_flops) != float(cpu.score_flops):
            raise AssertionError(f"{name}: score flops")
        out = card.out.cpu()
        for key in ("pruned", "kept_tokens", "h2c"):
            if key in cpu.info and not torch.equal(card.info[key].cpu(),
                                                   cpu.info[key]):
                raise AssertionError(f"{name}: {key} differs")
        if "reps" in cpu.info:
            creps, reps = card.info["reps"].cpu(), cpu.info["reps"]
            h2c = cpu.info["h2c"]
            for bi, ci in zip(*torch.nonzero(creps != reps, as_tuple=True)):
                members = set(torch.nonzero(h2c[bi] == ci)[:, 0].tolist())
                if members != {int(creps[bi, ci]), int(reps[bi, ci])}:
                    raise AssertionError(f"{name}: reps differ")
            if not torch.equal(creps, reps):
                # a two-head tie: chai held through the CPU's membership;
                # chai-qkv has no static form, so its output is not held
                log(f"{name}: a two-head tie, reps {creps.tolist()} on the "
                    f"card, {reps.tolist()} on the CPU")
                out = (policy.apply_policy(
                    "chai-static", *qkv, h2c_static=h2c[0].to(dev),
                    reps_static=reps[0].to(dev)).out.cpu()
                    if name == "chai" else cpu.out)
        torch.testing.assert_close(out, cpu.out, **TOL)
        if name == "chai":
            static = cpu.info
        mha = cpu.out if mha is None else mha
        dev_mha = float((cpu.out - mha).abs().max())
        rows.append((name, float(cpu.score_flops), dev_mha, ms,
                     float((out - cpu.out).abs().max())))
    log(f"policies on layer-0 q/k/v of a {POLICY_T}-token prefill "
        f"({h} heads, hd {cfg.head_dim}, fp32, TF32 off; n_clusters "
        f"{max(1, h // 2)}): (policy, score_flops, max |out - mha|, card "
        f"ms, max |card - CPU|): {rows}")


# ----------------------------------------------------------- phase 17 ----
# The failure model on chai-llama-7b (phase 6's engine settings). The
# soak's workload: ``build_workload(0, SOAK_REQUESTS)`` at page 16 and the
# model's vocabulary, with its priority-1 arrivals, and one request more:
# the duplicated family prompt again at step SOAK_DUP_STEP, once its CHAI
# snapshot exists, so a snapshot restore takes place (in the 12 the
# second duplicate is admitted in the step whose CLUSTER transition
# captures the first one's). The soak's engine has SOAK_SLOTS slots, so
# the priority-1 arrivals find them full and preempt (twice in the clean
# run; the schedule depends on token counts only). SOAK_PLAN arms every
# site the port serves but kernel.decode (phase 17b's) and the swap sites
# (phase 20b's), each uid pin on a request that reaches its site.
SOAK_REQUESTS = 12
SOAK_SLOTS = 2
SOAK_DUP_STEP = 41
SOAK_DUP_NEW = 8
SOAK_PLAN = (dict(site="pool.alloc", mode="transient"),
             dict(site="pool.alloc", mode="error", uid=5),
             dict(site="snapshot.restore"),
             dict(site="relay.residency"),
             dict(site="kernel.prefill", uid=1),
             dict(site="kernel.cluster", uid=4),
             dict(site="step.logits", mode="nan", uid=2))
SOAK_TERMINAL = ("length", "stop", "aborted", "error")
# Phase 17b: phase 6's traffic with kernel.decode armed at decode step
# DEGRADE_AT (every slot STEADY by then), healing after HEAL_STEPS clean
# steps. Phase 17c: phase 6's traffic at each audit level in turns.
DEGRADE_AT = 8
HEAL_STEPS = 8
AUDIT_TURNS = ("off", "basic", "deep")


def soak_workload(cfg):
    wl = soak_mod.build_workload(0, SOAK_REQUESTS, page_size=PAGE,
                                 vocab=cfg.vocab_size)
    dup = next(w["prompt"] for w in wl
               if sum(v["prompt"] == w["prompt"] for v in wl) > 1)
    wl.append(dict(step=SOAK_DUP_STEP, prompt=list(dup),
                   max_new=SOAK_DUP_NEW, priority=0, abort_at=None))
    return wl


class _SoakCore(EngineCore):
    """The soak's engine (``serving.soak`` builds it), its greedy margins
    recorded (``_record_margins``), each one built kept in ``built``."""
    built = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.margins = _record_margins(self)
        _SoakCore.built.append(self)


def _soak_run(cfg, params, wl, plan):
    """One ``run_soak`` of ``wl`` under ``plan`` (None: fault-free), deep
    audit after every step; returns (report, launches, engine, wall s)."""
    ecfg = EngineConfig(batch_slots=SOAK_SLOTS, max_seq=MAX_SEQ,
                        page_size=PAGE, prefix_cache=True, relay_decode=True,
                        audit_level="deep")
    faults = (None if plan is None else
              FaultInjector([FaultSpec(**a) for a in plan]))
    _SoakCore.built.clear()
    soak_mod.EngineCore = _SoakCore
    try:
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        rep = soak_mod.run_soak(cfg, params, ecfg, faults=faults,
                                workload=[dict(w) for w in wl])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launches()
    finally:
        soak_mod.EngineCore = EngineCore
    core, = _SoakCore.built
    label = "clean" if plan is None else "faulted"
    fs = rep["fault_stats"]
    finishes = {u: r["finish"] for u, r in rep["requests"].items()}
    if (rep["unfinished"] or rep["leaks"]
            or not set(finishes.values()) <= set(SOAK_TERMINAL)
            or len(finishes) != len(wl)):
        raise AssertionError(f"soak {label}: finishes {finishes}, "
                             f"unfinished {rep['unfinished']}, leaks "
                             f"{rep['leaks']}")
    if fs["audit_steps"] != rep["steps"]:
        raise AssertionError(f"soak {label}: {fs['audit_steps']} deep "
                             f"audits over {rep['steps']} steps")
    if any(r["finish"] == "error" and not r["error"]
           for r in rep["requests"].values()):
        raise AssertionError(f"soak {label}: an error without a message")
    return rep, launches, core, wall


def _hold_soak(clean, faulted, margins):
    """The parity set of ``run_soak_pair`` (completed requests no firing
    names) held against the clean run's tokens: equal up to a first
    divergence that sits on a clean top-2 margin <= CHUNK_MARGIN (bf16
    rounding: a relay group dissolved, a prefix hit where the clean run
    restored a snapshot). Returns (uids held, tokens compared,
    divergences)."""
    touched = soak_mod.affected_uids(faulted)
    done = ("length", "stop")
    uids = [u for u, r in faulted["requests"].items()
            if u not in touched and r["finish"] in done
            and clean["requests"][u]["finish"] in done]
    compared, parted = 0, []
    for u in uids:
        got, want = (faulted["requests"][u]["tokens"],
                     clean["requests"][u]["tokens"])
        gaps = margins.get(u, [])
        off = len(want) - len(gaps)      # tokens a snapshot supplied
        for k, (a, b) in enumerate(zip(got, want)):
            compared += 1
            if a != b:
                gap = gaps[k - off] if k >= off else None
                if gap is None or gap > CHUNK_MARGIN:
                    raise AssertionError(
                        f"soak uid {u} token {k}: {a} != {b} at clean "
                        f"margin {gap}")
                parted.append((u, k, round(gap, 5)))
                break
        else:
            if len(got) != len(want):
                raise AssertionError(f"soak uid {u}: {len(got)} tokens, "
                                     f"clean {len(want)}")
    if not uids:
        raise AssertionError("soak: empty parity set")
    return uids, compared, parted


def soak_path(cfg, params):
    """Phase 17a: the soak, clean and twice under SOAK_PLAN. Returns
    {path: launches}. On the first SIDE_DEPTH layers."""
    cfg, params = cut_depth(cfg, params)
    wl = soak_workload(cfg)
    clean, c_launches, c_core, c_wall = _soak_run(cfg, params, wl, None)
    if not (c_core.cluster_transitions and c_core.relay_steps
            and clean["prefix_stats"]["snapshot_hits"]
            and clean["preemptions"]):
        raise AssertionError(
            f"soak clean: {c_core.cluster_transitions} CLUSTER "
            f"transitions, {c_core.relay_steps} relay steps, "
            f"{clean['preemptions']} preemptions, prefix stats "
            f"{clean['prefix_stats']}")
    for name in ("paged_chai_fused_decode", "relay_prefix_decode",
                 "flash_prefill", "paged_prefix_attend"):
        if not c_launches[name]:
            raise AssertionError(f"soak clean: no {name} launch "
                                 f"{c_launches}")
    runs = [_soak_run(cfg, params, wl, SOAK_PLAN) for _ in range(2)]
    (faulted, f_launches, f_core, f_wall), (again, _, _, a_wall) = runs
    fired = faulted["fault_stats"]["injector"]["fired"]
    if again["fault_stats"]["injector"]["fired"] != fired:
        raise AssertionError("soak: the two faulted runs fired differently")
    if {f["site"] for f in fired} != {a["site"] for a in SOAK_PLAN}:
        raise AssertionError(f"soak: arms fired {fired}")
    fs = faulted["fault_stats"]
    if fs["relay_dissolved"] != 1 or fs["quarantined"] < 4:
        raise AssertionError(f"soak faulted: fault stats {fs}")
    uids, compared, parted = _hold_soak(clean, faulted, c_core.margins)
    same = again["requests"] == faulted["requests"]
    finishes = {}
    for r in faulted["requests"].values():
        finishes[r["finish"]] = finishes.get(r["finish"], 0) + 1
    log(f"soak ({len(wl)} requests, deep audit every step): clean "
        f"{clean['steps']} steps in {c_wall:.3f} s, "
        f"{c_core.cluster_transitions} CLUSTER transitions, "
        f"{c_core.relay_steps} relay steps, {clean['preemptions']} "
        f"preemptions, snapshot hits "
        f"{clean['prefix_stats']['snapshot_hits']}, launches {c_launches}")
    log(f"soak faulted: {faulted['steps']} steps in {f_wall:.3f} s (again "
        f"{a_wall:.3f} s), finishes {finishes}, fault stats "
        f"{ {k: v for k, v in fs.items() if k != 'injector'} }, fired "
        f"{[(f['site'], f['step'], f['uid']) for f in fired]}; the second "
        f"faulted run fired identically, its requests "
        f"{'identical' if same else 'NOT identical'}; parity uids {uids}: "
        f"{compared} tokens compared, divergences on margins {parted}; "
        f"launches {f_launches}")
    return {"fault_soak_clean": c_launches, "fault_soak_faulted": f_launches}


def degraded_path(cfg, params, mono):
    """Phase 17b: phase 6's paged traffic with ``kernel.decode`` armed at
    decode step DEGRADE_AT and ``decode_heal_steps=HEAL_STEPS``,
    clustering through phase 6's memberships. Returns {path: launches}."""
    inj = FaultInjector([FaultSpec("kernel.decode", step=DEGRADE_AT)])
    run = serve_continuous(cfg, params, "paged", faults=inj,
                           membership=mono["membership"],
                           decode_heal_steps=HEAL_STEPS)
    eng = run["eng"]
    fs = eng.fault_stats()
    if ((fs["decode_fallbacks"], fs["decode_heals"], fs["degraded_decode"])
            != (1, 1, False)):
        raise AssertionError(f"degraded: fault stats {fs}")
    steps = [st for st in run["per_step"] if st["decoded"]]
    degraded = [k for k, st in enumerate(steps) if st["degraded"]]
    if (degraded != list(range(DEGRADE_AT, DEGRADE_AT + HEAL_STEPS + 1))
            or any(steps[k]["fused"] for k in degraded)):
        raise AssertionError(f"degraded steps {degraded}: launches "
                             f"{[steps[k]['fused'] for k in degraded]}")
    kernel_steps = [st for st in steps if not st["degraded"]]
    healed = [st for st in steps[degraded[-1] + 1:] if st["chai_steps"]]
    if (not healed or any(st["fused"] != cfg.n_layers * st["chai_steps"]
                          for st in kernel_steps)):
        raise AssertionError("degraded: kernel-path steps' launches "
                             f"{[(st['fused'], st['chai_steps']) for st in kernel_steps]}")
    _check_served(cfg, run, "degraded")
    held, compared, parted = _hold_tokens(run, mono, label="degraded")
    times, calls = run["times"], run["calls"]
    per_call = {k: 1e3 * times[k] / calls[k] for k in calls}
    nan = float("nan")
    idx = [i for i, st in enumerate(run["per_step"]) if st["decoded"]]
    wall = {kind: statistics.median(1e3 * run["step_s"][idx[k]]
                                    for k in picks)
            for kind, picks in (
                ("degraded", degraded),
                ("kernels", [k for k, st in enumerate(steps)
                             if not st["degraded"] and st["chai_steps"]]))}
    log(f"degraded decode: fault at decode step {DEGRADE_AT}, "
        f"{len(degraded)} degraded steps (0 paged_chai_fused_decode "
        f"launches each), then {len(healed)} healed CHAI steps at "
        f"{cfg.n_layers} launches each; fault stats "
        f"{ {k: v for k, v in fs.items() if k != 'injector'} }; ms per "
        f"step call (device synchronized): degraded STEADY "
        f"{per_call.get('degraded_steady_step', nan):.2f} against the "
        f"kernels' STEADY {per_call.get('steady_step', nan):.2f} (mixed: "
        f"degraded {per_call.get('degraded_mixed_step', nan):.2f}, kernels "
        f"{per_call.get('mixed_step', nan):.2f}; calls {calls}); median "
        f"step() wall: degraded {wall['degraded']:.2f} ms, the kernels' "
        f"CHAI steps {wall['kernels']:.2f} ms; greedy tokens against phase 6's: {held} held on margins > "
        f"{CHUNK_MARGIN} of {compared} compared, divergences {parted}; "
        f"launches {run['launches']}")
    return {"fault_degraded_paged": run["launches"]}


# The host sleep between the profiler's window and the profiled call: the
# last one that gave a whole trace (``_decode_step_copies`` doubles it
# after a trace that is not, up to PROFILE_TRIES decode steps).
PROFILE_EDGE_S = [0.5]
PROFILE_TRIES = 6


def _profiled_copies(fn, edge_s):
    """``fn()`` under ``torch.profiler``; returns (the device-to-host
    copies in its trace, the number of device events in it, the device
    events counted by name), or None when the trace cannot be shown
    whole. The profiler drops the device records it dates outside its
    window, and its dating drifts: on the H100 the first 25 to 40
    kernels of a decode step went missing late in a run, and a whole trace
    needed 0.5 to 2 s of margin. So ``fn()`` runs between two spin kernels
    (``torch.cuda._sleep``, left out of the counts), each ``edge_s`` of
    host sleep from the window's edge; the trace is whole only if both
    spin kernels are in it, since ``fn()``'s device work runs between
    them in stream order."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(edge_s)
        torch.cuda._sleep(1000)
        fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(edge_s)
    device = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    events = [e for e in device if "spin_kernel" not in e.name]
    if len(device) - len(events) != 2:
        return None
    names = {}
    for e in events:
        names[e.name] = names.get(e.name, 0) + 1
    return sum("DtoH" in e.name for e in events), len(events), names


def _decode_step_copies(cfg, params, level, telemetry="off"):
    """Device-to-host copies in one all-STEADY decode step of a bare
    engine (no wrapper of this script) at ``audit_level`` and
    ``telemetry``. A step whose trace is not whole (``_profiled_copies``)
    is followed by the next all-STEADY step, with twice the sleep at the
    window's edges, up to PROFILE_TRIES steps; the edge that gave a whole
    trace is where the next profile starts."""
    core = EngineCore(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        audit_level=level, telemetry=telemetry))
    rng = np.random.default_rng(0)
    for n in CONT_PROMPT_LENS[:SLOTS]:
        core.add_request(rng.integers(0, cfg.vocab_size, size=n),
                         SamplingParams(max_new_tokens=16))
    while core.steps_executed < cfg.chai.warmup_tokens + 2:
        core.step()
    got = None
    for k in range(PROFILE_TRIES):
        n0 = core.steps_executed
        got = _profiled_copies(core.step, PROFILE_EDGE_S[0])
        if core.steps_executed != n0 + 1 or not (
                core._phases == chai_cache.PHASE_STEADY).all():
            raise AssertionError("the profiled step was no all-STEADY decode")
        if got is not None:
            break
        log(f"profile of decode step {n0} (audit {level}, telemetry "
            f"{telemetry}) at {PROFILE_EDGE_S[0]} s from the window's "
            "edges lost a bracketing spin kernel; profiling the next")
        PROFILE_EDGE_S[0] *= 2
    if got is None:
        raise AssertionError(f"no whole profile of a decode step in "
                             f"{PROFILE_TRIES} tries")
    for uid in range(SLOTS):
        core.abort(uid)
    return got


def audit_cost_path(cfg, params):
    """Phase 17c: phase 6's paged traffic on the first SIDE_DEPTH layers
    at audit_level off, basic and deep in turns (AUDIT_TURNS); the median
    step() wall of each run, the host time of each ``audit`` call, and the
    device-to-host copies of one decode step of those layers at each
    level. Returns {path: launches}."""
    audit = invariants_mod.audit
    step_ms = {lvl: [] for lvl in AUDIT_TURNS}
    audit_ms = {lvl: [] for lvl in AUDIT_TURNS}
    by_path = {}
    for lvl in AUDIT_TURNS:
        host = []

        def timed_audit(core, deep=False):
            t0 = time.perf_counter()
            out = audit(core, deep=deep)
            host.append(1e3 * (time.perf_counter() - t0))
            return out
        invariants_mod.audit = timed_audit
        try:
            run = serve_continuous(*cut_depth(cfg, params), "paged",
                                   audit_level=lvl)
        finally:
            invariants_mod.audit = audit
        _check_served(cfg, run, f"audit {lvl}")
        eng = run["eng"]
        if eng.audit_steps != (0 if lvl == "off" else len(run["step_s"])) \
                or len(host) != eng.audit_steps:
            raise AssertionError(f"audit {lvl}: {eng.audit_steps} audits, "
                                 f"{len(run['step_s'])} steps")
        step_ms[lvl].append(1e3 * statistics.median(run["step_s"]))
        audit_ms[lvl].append(statistics.median(host) if host else 0.0)
        by_path.setdefault(f"fault_audit_{lvl}", run["launches"])
        del eng
        run.clear()
    copies = {lvl: _decode_step_copies(*cut_depth(cfg, params), lvl)
              for lvl in ("off", "basic", "deep")}
    log(f"audit cost (phase 6's paged traffic, turns {AUDIT_TURNS}): median "
        f"step() ms " + ", ".join(
            f"{lvl} {[round(x, 3) for x in v]}" for lvl, v in step_ms.items())
        + "; median host ms of one audit call: " + ", ".join(
            f"{lvl} {[round(x, 4) for x in v]}" for lvl, v in audit_ms.items()
            if lvl != "off")
        + "; device-to-host copies in one all-STEADY decode step "
        "(torch.profiler; copies / device events): " + ", ".join(
            f"{lvl} {c[0]} / {c[1]}" for lvl, c in copies.items()))
    return by_path, copies


def front_door_faults(cfg, params):
    """Phase 17d: ``LLM(faults=...)`` with NaN logits armed on uid 1: its
    stream ends in a terminal chunk with finish_reason "error"; the other
    stream's tokens equal a clean LLM's. Returns {path: launches}."""
    prompts, sps = front_traffic(cfg, seeds=(None, None))
    prompts = prompts[:2]
    want = [o.token_ids for o in LLM(cfg, params, front_ecfg()).generate(
        prompts, sps)]
    llm = LLM(cfg, params, front_ecfg(), faults=FaultInjector(
        [FaultSpec("step.logits", mode="nan", uid=1)]))
    _reset_launches()
    streams = [llm.stream(p, sp) for p, sp in zip(prompts, sps)]
    chunks = [[next(s)] for s in streams]
    for s, got in zip(streams, chunks):
        got.extend(s)
    launches = _launches()
    ends = [(c[-1].finished, c[-1].finish_reason) for c in chunks]
    toks = [t for c in chunks[0] for t in c.token_ids]
    if (ends != [(True, FINISH_LENGTH), (True, "error")] or toks != want[0]
            or llm.core.fault_stats()["quarantined"] != 1):
        raise AssertionError(f"front door faults: ends {ends}, tokens "
                             f"{toks} against {want[0]}")
    llm.core.prefix_cache.clear()
    _pools_empty(llm.core, "front door faults")
    log(f"front door faults: stream uid 1 quarantined by NaN logits, its "
        f"last chunk {chunks[1][-1]}; stream uid 0's {len(toks)} tokens "
        f"equal a clean LLM's; launches {launches}")
    return {"fault_front_door": launches}


# ----------------------------------------------------------- phase 18 ----
# Telemetry on chai-llama-7b (phase 6's engine settings and traffic): one
# all-STEADY decode step of a bare engine profiled at "trace" against
# phase 17c's at audit basic (telemetry off); then phase 6's paged run at
# the three tiers in turns (TEL_TURNS), each clustering through phase 6's
# memberships, the one at "trace" checked span by span. A tier's spread:
# the interquartile range of its run's step() walls.
TEL_TURNS = ("off", "basic", "trace")
TEL_STAGES = ("cluster", "relay.form", "decode.dispatch", "sample",
              "retire", "step", "audit")
SPAN_PAIRS = 20000


def _span_host_us():
    """Host microseconds of one ``tel.span`` enter / exit pair at trace."""
    tel = make_telemetry("trace")
    tel.max_spans = SPAN_PAIRS
    t0 = time.perf_counter()
    for k in range(SPAN_PAIRS):
        with tel.span("x", step=k):
            pass
    return 1e6 * (time.perf_counter() - t0) / SPAN_PAIRS


def _check_trace_run(cfg, run):
    """Phase 18's checks on a run at "trace": the Chrome trace round trip,
    the spans of every step, the metric ground truths."""
    eng, done = run["eng"], run["done"]
    spans = eng.tel.spans
    evs = exporters.from_chrome_trace(json.dumps(eng.step_trace()))
    if [e["name"] for e in evs] != [sp["name"] for sp in spans] \
            or eng.tel.spans_dropped:
        raise AssertionError("telemetry: the Chrome trace does not "
                             "round-trip the spans")
    by_step = {}
    for sp in spans:
        by_step.setdefault(sp["step"], []).append(sp["name"])
    decoding = {k: v for k, v in by_step.items() if "decode.dispatch" in v}
    bad = {k: v for k, v in decoding.items()
           if v.count("admit") < 1
           or any(v.count(stage) != 1 for stage in TEL_STAGES)}
    steps = sorted(by_step)
    if (bad or len(decoding) != eng.steps_executed
            or steps != list(range(steps[0], steps[0] + len(steps)))
            or len(steps) != len(run["step_s"])):
        raise AssertionError(f"telemetry spans: {len(decoding)} decoding "
                             f"steps of {eng.steps_executed}, ordinals "
                             f"{steps[:3]}..{steps[-3:]}, bad {bad}")
    snap = eng.metrics()

    def counter(name, **labels):
        return sum(s["value"] for s in snap["counters"][name]["series"]
                   if all(s["labels"].get(k) == v for k, v in labels.items()))
    served = sum(len(r.generated) for r in done)
    ttft = snap["histograms"]["request_ttft_seconds"]["series"][0]["count"]
    truths = dict(tokens=(counter("tokens_generated_total"), served),
                  finished=(counter("requests_finished_total",
                                    reason=FINISH_LENGTH), len(done)),
                  ttft_count=(ttft, len(done)),
                  clusters=(counter("cluster_transitions_total"),
                            eng.cluster_transitions))
    if any(a != b for a, b in truths.values()) or len(done) != 8:
        raise AssertionError(f"telemetry ground truths {truths}")
    parsed = exporters.parse_prometheus(eng.metrics_text())
    return dict(spans=len(spans), steps=len(steps),
                decoding_steps=len(decoding),
                prometheus_samples=len(parsed["samples"]),
                chai_clusters=[s["value"] for s in
                               snap["gauges"]["chai_clusters"]["series"]],
                truths=truths)


def telemetry_path(cfg, params, off_copies):
    """Phase 18, on the first SIDE_DEPTH layers. ``off_copies``: phase
    17c's profile of a decode step at audit basic, telemetry off. The
    tier turns run phase 6's paged traffic: the first
    turn (off) is the reference of the others, whose requests cluster
    through its memberships; their launches equal its, and the trace
    turn's tokens are held against its. Returns ({path: launches}, the
    phase's record)."""
    side_cfg, side_params = cut_depth(cfg, params)
    copies = {"off": off_copies,
              "trace": _decode_step_copies(side_cfg, side_params, "basic",
                                           telemetry="trace")}
    if copies["off"][2] != copies["trace"][2] or any(
            c[0] != 1 for c in copies.values()):
        off, tr = copies["off"][2], copies["trace"][2]
        raise AssertionError(
            "telemetry: one all-STEADY decode step's device work differs at "
            f"off and trace: {copies['off'][:2]} against "
            f"{copies['trace'][:2]}; events by name, trace less off: "
            + str({k: tr.get(k, 0) - off.get(k, 0) for k in set(off) | set(tr)
                   if tr.get(k, 0) != off.get(k, 0)}))
    step_ms, spread = {}, {}
    rec = off = None
    for tier in TEL_TURNS:
        run = serve_continuous(
            side_cfg, side_params, "paged", telemetry=tier,
            membership=off["membership"] if off else None)
        _check_served(side_cfg, run, f"telemetry {tier}")
        if off is None:
            off = dict(tokens={r.uid: r.generated for r in run["done"]},
                       margins=run["margins"], membership=run["idents"],
                       launches=run["launches"])
        if run["launches"] != off["launches"]:
            raise AssertionError(f"telemetry {tier}: launches "
                                 f"{run['launches']} against the off run's "
                                 f"{off['launches']}")
        if tier == "trace" and rec is None:
            rec = _check_trace_run(side_cfg, run)
            held, compared, parted = _hold_tokens(run, off,
                                                  label="telemetry")
            launches = run["launches"]
        walls = [1e3 * t for t in run["step_s"]]
        step_ms[tier] = statistics.median(walls)
        q1, _, q3 = statistics.quantiles(walls, n=4)
        spread[tier] = q3 - q1
        run.clear()
    span_us = _span_host_us()
    diff = step_ms["trace"] - step_ms["off"]
    widest = max(spread.values())
    rec.update(copies={t: c[:2] for t, c in copies.items()},
               device_kernels=len(copies["off"][2]), step_ms=step_ms,
               step_iqr_ms=spread, span_us=span_us, trace_minus_off_ms=diff,
               largest_tier_spread_ms=widest,
               tokens=dict(held=held, compared=compared, parted=parted))
    log(f"telemetry (phase 6's paged traffic): one all-STEADY decode step "
        f"of a bare engine (audit basic): device-to-host copies / device "
        f"events off {copies['off'][:2]}, trace {copies['trace'][:2]}, the "
        f"same {len(copies['off'][2])} device kernel names and counts; a "
        f"run at trace: {rec['spans']} spans over {rec['steps']} steps "
        f"({rec['decoding_steps']} decoding, each with one "
        f"{'/'.join(TEL_STAGES)} and >= 1 admit), Chrome trace round-trips, "
        f"{rec['prometheus_samples']} Prometheus samples parse back, ground "
        f"truths {rec['truths']}, chai_clusters {rec['chai_clusters']}, "
        f"launches = the off run's {launches}; tokens against the off "
        f"run's ({side_cfg.n_layers} layers): {held} held on margins > "
        f"{CHUNK_MARGIN} of {compared} compared, divergences {parted}")
    log(f"telemetry host cost, turns {TEL_TURNS}: median step() ms "
        + ", ".join(f"{t} {step_ms[t]:.3f} (IQR {spread[t]:.3f})"
                    for t in TEL_TURNS)
        + f"; trace - off {diff:.3f} ms against the widest tier's IQR "
        f"{widest:.3f} ms ("
        + ("unresolved" if abs(diff) <= widest else "resolved")
        + f"); one tel.span enter/exit pair {span_us:.3f} us on the host")
    return {"telemetry_trace": launches}, rec


# ----------------------------------------------------------- phase 19 ----
# The KV tiers on chai-llama-7b: families of prompts sharing a
# SYS_LEN-token prefix (phase 8's system-prompt shape) with private
# suffixes, one family a wave, each wave drained before the next; the
# dense pool holds about two families' cached pages, so the third wave
# demotes the first family's blocks and snapshots to the host, and the
# last wave hits them again (new suffixes on the first prefix, and the
# first family's first prompt again: a CHAI snapshot hit).
TIER_SUFFIXES = ((32, 64), (48, 96), (40, 80), (56, 112))
TIER_NEW = 32
TIER_DENSE_PAGES = 111         # usable pages of the dense pool: 110
TIER_HOST_PAGES = 256          # per kind; a dense page is 1 MiB at bf16
TIER_SMALL_HOST = 12           # too few for the demoted set: int4 rung
TIER_COMP_PAGES = 192
TIER_COPY_PAGES = 16
LINK_BYTES = 256 << 20


def tier_waves(cfg):
    """[[(uid, prompt), ...], ...]: the phase's waves."""
    rng = np.random.default_rng(19)
    prefixes = [rng.integers(0, cfg.vocab_size, size=SYS_LEN).tolist()
                for _ in range(3)]
    waves, uid = [], 0
    for fam, lens in zip((0, 1, 2, 0), TIER_SUFFIXES):
        wave = []
        for n in lens:
            wave.append((uid, prefixes[fam]
                         + rng.integers(0, cfg.vocab_size, size=n).tolist()))
            uid += 1
        waves.append(wave)
    waves[-1].append((uid, list(waves[0][0][1])))    # a snapshot hit
    return waves


def _watch_tier_pages(eng):
    """Clone each demoted entry's device pages before its demotion and
    check at its promotion that the new pages hold the same bits; returns
    the (pool key, planes equal) list of promoted pages and the (tier,
    promoted) list of promotion attempts."""
    before, checked = {}, []
    demote, promote = eng._demote_entry, eng._promote_entry
    planes = {"dense": ("kvp", "kvp_scale"), "chai": ("cp", "cp_scale")}

    def read(pages_by_pk):
        st = eng._dev_state
        return {pk: [{k: st[k][:, p].clone()
                      for k in planes[kv_tiers_mod.POOL_OF[pk]] if k in st}
                     for p in pages] for pk, pages in pages_by_pk.items()}

    def watched_demote(entry):
        held = read(eng._entry_device_pages(entry))
        ok = demote(entry)
        if ok:
            before[id(entry)] = held
        return ok

    def watched_promote(entry, **kw):
        tier = entry.tier
        ok = promote(entry, **kw)
        attempts.append((tier, ok))
        if ok:
            now = read(eng._entry_device_pages(entry))
            want = before.pop(id(entry))
            for pk in now:
                for a, b in zip(now[pk], want[pk]):
                    checked.append((pk, all(torch.equal(a[k], b[k])
                                            for k in a)))
        return ok

    attempts = []
    eng.prefix_cache.demote_hook = watched_demote
    eng._promote_entry = watched_promote
    return checked, attempts


def serve_tiers(cfg, params, waves, faults=None, **ecfg_kw):
    """Serve the waves on a continuous paged engine with the prefix cache,
    each drained before the next, deep audit after every step; returns
    the run (engine, requests by uid, launches, step walls, pages
    checked at promotion)."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        prefix_cache=True, audit_level="deep", **ecfg_kw), faults=faults)
    checked, attempts = (_watch_tier_pages(eng) if eng.ecfg.kv_offload
                         else ([], []))
    step, step_s = eng.step, []

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out
    eng.step = timed_step
    _reset_launches()
    t0 = time.time()
    for wave in waves:
        for uid, prompt in wave:
            eng.submit(prompt, max_new_tokens=TIER_NEW, uid=uid)
        eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches()
    reqs = {r.uid: r for r in eng.done}
    if (sorted(reqs) != [u for w in waves for u, _ in w]
            or any(r.finish_reason != FINISH_LENGTH
                   or len(r.generated) != TIER_NEW for r in reqs.values())):
        raise AssertionError(f"tiers: finishes "
                             f"{[(u, r.finish_reason) for u, r in reqs.items()]}")
    n_prefix = sum(r.cache_hit == "prefix" for r in reqs.values())
    want = cfg.n_layers * n_prefix
    if (launches["flash_prefill"] != want
            or launches["paged_prefix_attend"] != want):
        raise AssertionError(f"tiers: {n_prefix} suffix prefills, "
                             f"launches {launches}")
    return dict(eng=eng, reqs=reqs, launches=launches, wall=wall,
                step_s=step_s, checked=checked, attempts=attempts)


def _plans(run):
    return {u: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
            for u, r in run["reqs"].items()}


def _empty_after_clear(eng, label):
    """``clear()`` demotes or drops every hot entry; dropping the demoted
    ones then must leave the device and the host pools empty."""
    cache = eng.prefix_cache
    cache.clear()
    for lru in eng.tiers._lru.values():
        for e in list(lru.values()):
            cache.drop_demoted(e)
    left = {"dense": eng.dense_pool.pages_in_use,
            "chai": eng.chai_pool.pages_in_use,
            **{f"{t}/{k}": n for (t, k), n in eng.tiers.tier_pages().items()}}
    if any(left.values()) or invariants_mod.audit_leaks(eng):
        raise AssertionError(f"{label}: pools after a clear {left}")


def _event_ms(fn, reps=1):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def page_copy_times(eng):
    """Demotion and promotion of TIER_COPY_PAGES pages of each pool
    through the engine's own page read and write (CUDA events around the
    copies; the CRC on the host clock), beside a LINK_BYTES pinned
    host <-> device copy, which measures the host link."""
    out = {}
    host = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(LINK_BYTES, dtype=torch.uint8, device="cuda")
    h2d = statistics.median(_event_ms(
        lambda: dev.copy_(host, non_blocking=True))[0] for _ in range(5))
    d2h = statistics.median(_event_ms(
        lambda: host.copy_(dev, non_blocking=True))[0] for _ in range(5))
    del host, dev
    out["link"] = dict(bytes=LINK_BYTES, h2d_ms=h2d, d2h_ms=d2h,
                       h2d_gb_s=LINK_BYTES / h2d / 1e6,
                       d2h_gb_s=LINK_BYTES / d2h / 1e6)
    st, take = eng._dev_state, eng.tiers.slabs.take
    pages = list(range(1, TIER_COPY_PAGES + 1))
    for kind in eng._fetch_page:
        fetch, put = eng._fetch_page[kind], eng._put_page[kind]
        fetch(st, pages[0], take)                       # warm the slabs
        torch.cuda.synchronize()
        down, payloads = _event_ms(lambda: [fetch(st, p, take)
                                            for p in pages])
        t0 = time.perf_counter()
        for pl in payloads:
            kv_tiers_mod.payload_crc({"kg": [pl]})
        crc = 1e3 * (time.perf_counter() - t0) / len(pages)
        up, _ = _event_ms(lambda: [put(st, p, pl)
                                   for p, pl in zip(pages, payloads)])
        nbytes = sum(v.numel() * v.element_size()
                     for v in payloads[0].values())
        down, up = down / len(pages), up / len(pages)
        out[kind] = dict(page_bytes=nbytes, demote_copy_ms=down,
                         crc_host_ms=crc, promote_copy_ms=up,
                         demote_gb_s=nbytes / down / 1e6,
                         promote_gb_s=nbytes / up / 1e6,
                         demote_share_of_d2h=(nbytes / down)
                         / (LINK_BYTES / d2h),
                         promote_share_of_h2d=(nbytes / up)
                         / (LINK_BYTES / h2d))
        for pl in payloads:
            for v in pl.values():
                eng.tiers.slabs.give(v)
    return out


def kv_tiers_path(cfg, params):
    """Phase 19, every run on the first SIDE_DEPTH layers (a page holds
    each global layer's rows: 1 MiB at bf16). Returns ({path: launches},
    the phase's record)."""
    cfg, params = cut_depth(cfg, params)
    waves = tier_waves(cfg)
    roomy = serve_tiers(cfg, params, waves)             # nothing demotes
    if roomy["eng"].prefix_stats()["evicted_blocks"]:
        raise AssertionError("tiers: the roomy run evicted")
    _empty_after_clear(roomy["eng"], "tiers roomy")
    base_plans = _plans(roomy)
    tokens = {u: r.generated for u, r in roomy["reqs"].items()}
    roomy.clear()
    run = serve_tiers(cfg, params, waves, kv_offload=True,
                      num_pages=TIER_DENSE_PAGES, host_pages=TIER_HOST_PAGES)
    eng = run["eng"]
    st, ts = eng.prefix_stats(), eng.tier_stats()
    checked = run["checked"]
    if not (st["demoted_blocks"] and st["promoted_blocks"]
            and st["demoted_snapshots"] and st["promoted_snapshots"]
            and st["evicted_blocks"] == st["evicted_snapshots"] == 0):
        raise AssertionError(f"tiers: prefix stats {st}")
    if not checked or not all(ok for _, ok in checked):
        raise AssertionError(f"tiers: promoted pages {checked}")
    if _plans(run) != base_plans:
        raise AssertionError(f"tiers: plans {_plans(run)} against the "
                             f"roomy run's {base_plans}")
    differ = [u for u, r in run["reqs"].items() if r.generated != tokens[u]]
    if differ:
        raise AssertionError(f"tiers: tokens of {differ} differ from the "
                             "roomy run's")
    copies = page_copy_times(eng)
    pinned = eng.tiers.slabs.slab_bytes
    _empty_after_clear(eng, "tiers offload")
    rec = dict(prefix_stats=st, tier_stats=ts, pages_checked=len(checked),
               plans=base_plans, wall=run["wall"],
               median_step_ms=1e3 * statistics.median(run["step_s"]),
               pinned_slab_bytes=pinned, copies=copies)
    launches = {"tiers_offload": run["launches"]}
    run.clear()
    # the corrupt offload.out arm: caught at promotion, re-planned cold
    bad = serve_tiers(cfg, params, waves, kv_offload=True,
                      num_pages=TIER_DENSE_PAGES, host_pages=TIER_HOST_PAGES,
                      faults=FaultInjector([FaultSpec(
                          "offload.out", mode="corrupt", count=-1)]))
    beng = bad["eng"]
    bst, bfs = beng.prefix_stats(), beng.fault_stats()
    if not (bfs["offload_checksum_failures"] > 0 and bfs["quarantined"] == 0
            and bst["promoted_blocks"] == bst["promoted_snapshots"] == 0):
        raise AssertionError(f"tiers corrupt: {bst}, "
                             f"{ {k: v for k, v in bfs.items() if k != 'injector'} }")
    rec["corrupt"] = dict(checksum_failures=bfs["offload_checksum_failures"],
                          fired=len(bfs["injector"]["fired"]),
                          plans=_plans(bad))
    _empty_after_clear(beng, "tiers corrupt")
    launches["tiers_corrupt"] = bad["launches"]
    bad.clear()
    # a host pool too small for the demoted set: the int4 rung
    small = serve_tiers(cfg, params, waves, kv_offload=True,
                        num_pages=TIER_DENSE_PAGES, host_pages=TIER_SMALL_HOST,
                        compressed_pages=TIER_COMP_PAGES)
    sts = small["eng"].tier_stats()
    tr = sts["transitions"]
    comp_hits = small["attempts"].count((kv_tiers_mod.TIER_COMP, False))
    if not (tr.get("host->compressed/dense", 0) and comp_hits
            and not tr.get("compressed->hot/dense", 0)):
        raise AssertionError(f"tiers small host: transitions {tr}, "
                             f"promotion attempts {small['attempts']}")
    rec["small_host"] = dict(transitions=tr, plans=_plans(small),
                             compressed_hits=comp_hits,
                             tier_bytes=sts["tier_bytes"])
    _empty_after_clear(small["eng"], "tiers small host")
    launches["tiers_small_host"] = small["launches"]
    small.clear()
    log(f"KV tiers ({sum(len(w) for w in waves)} requests in {len(waves)} "
        f"waves over 3 families of a {SYS_LEN}-token prefix; dense pool "
        f"{TIER_DENSE_PAGES - 1} pages, host {TIER_HOST_PAGES} a kind; deep "
        f"audit every step): {rec['wall']:.3f} s, median step "
        f"{rec['median_step_ms']:.2f} ms; prefix stats {st}; transitions "
        f"{ts['transitions']}; prefetch hits {ts['prefetch_hits']}, misses "
        f"{ts['prefetch_misses']}; {len(checked)} promoted pages torch.equal "
        f"to their pages before demotion; plans and tokens = the roomy "
        f"run's {base_plans}; pinned slabs {pinned:,} B; launches "
        f"{launches['tiers_offload']}")
    log(f"KV tiers corrupt offload.out: {rec['corrupt']['fired']} arms "
        f"fired, {rec['corrupt']['checksum_failures']} checksum failures at "
        f"promotion, nothing promoted or quarantined, plans "
        f"{rec['corrupt']['plans']}; host pool of {TIER_SMALL_HOST}: "
        f"transitions {tr}, {comp_hits} compressed hits dropped and "
        f"re-planned, plans {rec['small_host']['plans']}")
    for kind in copies:
        if kind == "link":
            continue
        c = copies[kind]
        log(f"KV tiers page copies ({kind}, {c['page_bytes']:,} B a page, "
            f"{TIER_COPY_PAGES} pages): demotion {c['demote_copy_ms']:.4f} "
            f"ms a page ({c['demote_gb_s']:.2f} GB/s, "
            f"{100 * c['demote_share_of_d2h']:.1f}% of the link's D2H), "
            f"host CRC {c['crc_host_ms']:.4f} ms, promotion "
            f"{c['promote_copy_ms']:.4f} ms ({c['promote_gb_s']:.2f} GB/s, "
            f"{100 * c['promote_share_of_h2d']:.1f}% of the link's H2D)")
    link = copies["link"]
    log(f"host link ({LINK_BYTES:,} B pinned, median of 5): H2D "
        f"{link['h2d_ms']:.3f} ms ({link['h2d_gb_s']:.2f} GB/s), D2H "
        f"{link['d2h_ms']:.3f} ms ({link['d2h_gb_s']:.2f} GB/s)")
    return launches, rec


# ----------------------------------------------------------- phase 20 ----
# Priority preemption on full-width chai-llama-7b (phase 6's weights), the
# continuous paged engine with 2 slots and pools just above one request's
# need (``tests/test_slo_serving.py``'s shape): a request of
# PREEMPT_PROMPT + PREEMPT_NEW tokens takes PREEMPT_PAGES pages of each of
# K and V; the dense pool holds 2 * PREEMPT_PAGES + 1 usable pages, the
# clustered one PREEMPT_PAGES + 1, so a second request never fits beside
# a first and a priority-5 arrival preempts it. The victim runs
# PREEMPT_STEADY_AT steps (STEADY: warmup 5), PREEMPT_WARMUP_AT (WARMUP) or
# one chunk of PREEMPT_CHUNK tokens (PREFILL) before the arrival.
PREEMPT_PROMPT = 160
PREEMPT_NEW = 16
PREEMPT_PAGES = -(-(PREEMPT_PROMPT + PREEMPT_NEW) // PAGE)
PREEMPT_STEADY_AT = 8
PREEMPT_WARMUP_AT = 2
PREEMPT_CHUNK = 64
SWAP_REPS = 5
ASYNC_STREAMS = 16             # 4 of them aborted after their first chunk
ASYNC_PROMPT = 32
ASYNC_NEW = 8


def preempt_ecfg(**kw):
    chai = {} if kw.get("use_chai") is False else {
        "num_chai_pages": PREEMPT_PAGES + 2}
    return EngineConfig(batch_slots=2, max_seq=MAX_SEQ, page_size=PAGE,
                        num_pages=2 * PREEMPT_PAGES + 2, audit_level="deep",
                        **chai, **kw)


def _pool_state(core):
    return (core.dense_pool.counters(),
            core.chai_pool.counters() if core.chai_pool else None,
            dict(core.tiers.tier_pages()))


def _alone(cfg, params, prompt, **kw):
    """A request's tokens alone on a fresh preemption engine."""
    core = EngineCore(cfg, params, preempt_ecfg(**kw))
    req = core.add_request(prompt, SamplingParams(max_new_tokens=PREEMPT_NEW))
    while core.has_work():
        core.step()
    return list(req.generated)


def swap_page_times(core, i):
    """Slot ``i``'s swap piece by piece on the engine's own functions and
    host buffers (SWAP_REPS times, medians; CUDA events around the device
    work, the host clock around the CRC): the gather
    (``save_slot_paged``), the non-blocking copies of every page into the
    pinned host buffers, the CRC over the columns and pages, the upload
    into staging buffers and the scatter (``load_slot_paged``), which
    writes the same bytes back. Returns ms a page and the bytes."""
    pages = core._slot_pages[i]
    keys = ("kg", "vg", "kc", "vc")
    ids = [core._page_ids(pages.get(k, ())) for k in keys]
    vecs = [core._page_vec(pages.get(k, [])) for k in keys]
    n = sum(len(pages.get(k, ())) for k in keys)
    slabs = core.tiers.slabs
    st = core._dev_state
    acc = {k: [] for k in ("gather", "copy", "crc", "upload", "scatter")}
    nbytes = 0
    for _ in range(SWAP_REPS):
        torch.cuda.synchronize()
        ms, (cols, pools) = _event_ms(lambda: core._swap_out(st, i, *ids))
        acc["gather"].append(ms)
        planes = {k: v.movedim(1, 0).contiguous() for k, v in pools.items()
                  if v.shape[1]}
        torch.cuda.synchronize()
        ms, host = _event_ms(lambda: {
            k: [slabs.take(tuple(x.shape[1:]), x.dtype).copy_(
                x[j], non_blocking=True) for j in range(x.shape[0])]
            for k, x in planes.items()})
        acc["copy"].append(ms)
        cols_host = {k: v.cpu() for k, v in cols.items()}
        t0 = time.perf_counter()
        faults_mod.checksum_arrays({"cols": cols_host, "pools": {
            k: {str(j): {"data": b} for j, b in enumerate(bufs)}
            for k, bufs in host.items()}})
        acc["crc"].append(1e3 * (time.perf_counter() - t0))
        nbytes = sum(b.numel() * b.element_size()
                     for bufs in host.values() for b in bufs)

        def upload():
            dev = {}
            for k, bufs in host.items():
                d = torch.empty((len(bufs),) + tuple(bufs[0].shape),
                                dtype=bufs[0].dtype, device="cuda")
                for j, b in enumerate(bufs):
                    d[j].copy_(b, non_blocking=True)
                dev[k] = d.movedim(0, 1)
            return dev
        ms, dev = _event_ms(upload)
        acc["upload"].append(ms)
        ms, _ = _event_ms(lambda: core._swap_in(st, i, cols, dev, *ids,
                                                *vecs))
        acc["scatter"].append(ms)
        for bufs in host.values():
            for b in bufs:
                slabs.give(b)
    out = {f"{k}_ms_a_page": statistics.median(v) / n
           for k, v in acc.items()}
    out.update(pages=n, page_bytes=nbytes // n, slot_bytes=nbytes)
    return out


def preempt_run(cfg, params, prompts, at, label, want, faults=None,
                kernel="paged_chai_fused_decode", timed=False, **kw):
    """The victim (priority 0) alone for ``at`` steps (a chunked one:
    until it is mid-PREFILL), then the preemptor (priority 5), drained,
    the launches counted over the run and per step. Held: tokens equal to
    ``want`` (each request alone) unless ``faults`` quarantine the victim;
    one preemption; ``kernel`` launched once a layer on every decode step
    of the victim's return in its kernel phase (STEADY, or any with CHAI
    off); the pools and host tier back at their base. ``timed``: the swap
    timed piece by piece before the arrival, and the engine's own swap-out
    and swap-in on the host clock. Returns the run's record."""
    core = EngineCore(cfg, params, preempt_ecfg(**kw), faults=faults)
    _check_logits(core, cfg.vocab_size)
    lk = ck.LAUNCHES if kernel in ck.LAUNCHES else fk.LAUNCHES
    base = _pool_state(core)
    sp = SamplingParams(max_new_tokens=PREEMPT_NEW)
    walls = {}
    for name in ("_swap_out_slot", "_swap_in_slot"):
        fn = getattr(core, name)

        def wall(*a, _fn=fn, _n=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                walls.setdefault(_n, []).append(
                    1e3 * (time.perf_counter() - t0))
        setattr(core, name, wall)
    steps_rec = []
    _reset_launches()
    t0 = time.time()
    victim = core.add_request(prompts[0], sp, priority=0)

    def step():
        n0, k0 = core.steps_executed, lk[kernel]
        core.step()
        back = victim.preemptions > 0 and victim in core._slot_req
        steps_rec.append(dict(
            decoded=core.steps_executed > n0, launches=lk[kernel] - k0,
            victim_back=back,
            victim_phase=int(core._phases[victim.slot]) if back else None))
    for _ in range(at):
        step()
    swap = swap_page_times(core, victim.slot) if timed else None
    preemptor = core.add_request(prompts[1], sp, priority=5)
    while core.has_work():
        step()
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = _launches()
    core.reap_done()
    if core.preemptions != 1 or victim.preemptions != 1:
        raise AssertionError(f"{label}: {core.preemptions} preemptions")
    if list(preemptor.generated) != want[1]:
        raise AssertionError(f"{label}: preemptor tokens "
                             f"{preemptor.generated} != alone {want[1]}")
    fs = core.fault_stats()
    if faults is None:
        if list(victim.generated) != want[0]:
            raise AssertionError(f"{label}: victim tokens "
                                 f"{victim.generated} != alone {want[0]}")
        if fs["swap_checksum_failures"] or fs["quarantined"]:
            raise AssertionError(f"{label}: fault stats {fs}")
        kphase = (chai_cache.PHASE_STEADY if kw.get("use_chai", True)
                  else None)
        back = [r for r in steps_rec if r["victim_back"] and r["decoded"]
                and (kphase is None or r["victim_phase"] == kphase)]
        if not back or any(r["launches"] != cfg.n_layers for r in back):
            raise AssertionError(f"{label}: {kernel} launches on the "
                                 f"victim's return {back}")
    if _pool_state(core) != base:
        raise AssertionError(f"{label}: pools {_pool_state(core)} against "
                             f"their base {base}")
    rec = dict(victim=list(victim.generated), finish=victim.finish_reason,
               error=victim.error, preemptor=list(preemptor.generated),
               launches=launches, wall_s=wall_s, fault_stats={
                   k: v for k, v in fs.items() if k != "injector"},
               fired=[(f["site"], f["uid"]) for f in
                      (fs["injector"] or {"fired": []})["fired"]],
               return_steps=sum(r["victim_back"] and r["decoded"]
                                for r in steps_rec),
               swap=swap, swap_walls_ms=walls)
    log(f"preemption {label}: {wall_s:.3f} s, victim "
        f"{victim.finish_reason} ({len(victim.generated)} tokens"
        f"{', ' + victim.error if victim.error else ''}), preemptor "
        f"{len(preemptor.generated)} tokens, {rec['return_steps']} decode "
        f"steps after the victim's return; fault stats "
        f"{rec['fault_stats']}, fired {rec['fired']}; engine swap walls "
        f"{ {k: [round(x, 3) for x in v] for k, v in walls.items()} } ms; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return rec


def preemption_path(cfg, params):
    """Phase 20a and 20b, every run on the first SIDE_DEPTH layers.
    Returns ({path: launches}, the record)."""
    cfg, params = cut_depth(cfg, params)
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, size=PREEMPT_PROMPT)
               for _ in range(2)]
    want = [_alone(cfg, params, p) for p in prompts]
    runs = {}
    runs["steady"] = preempt_run(cfg, params, prompts, PREEMPT_STEADY_AT,
                                 "steady victim", want, timed=True)
    runs["warmup"] = preempt_run(cfg, params, prompts, PREEMPT_WARMUP_AT,
                                 "warmup victim", want)
    want_c = [_alone(cfg, params, p, prefill_chunk_tokens=PREEMPT_CHUNK)
              for p in prompts]
    runs["prefill"] = preempt_run(cfg, params, prompts, 1, "prefill victim",
                                  want_c, prefill_chunk_tokens=PREEMPT_CHUNK)
    want_m = [_alone(cfg, params, p, use_chai=False) for p in prompts]
    runs["mha"] = preempt_run(cfg, params, prompts, PREEMPT_STEADY_AT,
                              "MHA baseline victim", want_m,
                              kernel="paged_decode", use_chai=False)
    for site, word in (("swap.corrupt", "checksum mismatch"),
                       ("swap.in", "swap-in failure")):
        r = preempt_run(cfg, params, prompts, PREEMPT_STEADY_AT,
                        f"{site} armed", want, faults=FaultInjector(
                            [FaultSpec(site, mode="corrupt" if site ==
                                       "swap.corrupt" else "error")]))
        fs = r["fault_stats"]
        if (r["finish"] != "error" or word not in r["error"]
                or fs["quarantined"] != 1 or r["fired"] != [(site, 0)]
                or fs["swap_checksum_failures"]
                != int(site == "swap.corrupt")):
            raise AssertionError(f"{site}: {r}")
        runs[site] = r
    sw = runs["steady"]["swap"]
    log(f"preemption swap of a STEADY slot ({sw['pages']} pages, "
        f"{sw['slot_bytes']:,} B; medians of {SWAP_REPS}): per page gather "
        f"{sw['gather_ms_a_page']:.4f} ms, copy to pinned host "
        f"{sw['copy_ms_a_page']:.4f} ms, host CRC "
        f"{sw['crc_ms_a_page']:.4f} ms, upload "
        f"{sw['upload_ms_a_page']:.4f} ms, scatter "
        f"{sw['scatter_ms_a_page']:.4f} ms")
    launches = {f"preempt_{k.replace('.', '_')}": r["launches"]
                for k, r in runs.items()}
    return launches, {k: {kk: vv for kk, vv in r.items() if kk != "launches"}
                      for k, r in runs.items()}


def async_path(cfg, params):
    """Phase 20c: ASYNC_STREAMS concurrent ``AsyncLLM`` streams on phase
    6's engine settings, ASYNC_ABORTS of them aborted after their first
    chunk; the survivors equal the synchronous ``LLM``'s tokens, every
    page back. Then the HTTP server's ``selftest`` on loopback ports the
    OS picks, its engine built on the same weights. Returns ({path:
    launches}, the record)."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=ASYNC_PROMPT)
               for _ in range(ASYNC_STREAMS)]
    sp = SamplingParams(max_new_tokens=ASYNC_NEW)
    ecfg = EngineConfig(batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE)
    sync = LLM(cfg, params, ecfg)
    torch.cuda.synchronize()
    t0 = time.time()
    want = [o.token_ids for o in sync.generate(prompts, sp)]
    sync_ms = 1e3 * (time.time() - t0) / sync.core.steps_executed
    aborted = {i for i in range(ASYNC_STREAMS) if i % 4 == 3}

    async def stream(llm, i):
        chunks = []
        async for c in llm.stream(prompts[i], sp):
            chunks.append(c)
            if i in aborted and len(chunks) == 1:
                if not await llm.abort(c.uid):
                    raise AssertionError(f"async: abort of stream {i}")
        toks = [t for c in chunks for t in c.token_ids]
        last = chunks[-1]
        if i in aborted:
            if (last.finish_reason != "aborted" or last.token_ids
                    or len(toks) >= ASYNC_NEW):
                raise AssertionError(f"async: aborted stream {i} {chunks}")
        elif toks != want[i]:
            raise AssertionError(f"async: stream {i} {toks} != {want[i]}")
        return toks

    async def run():
        async with AsyncLLM(cfg, params, ecfg) as llm:
            base = _pool_state(llm.core)
            t0 = time.time()
            await asyncio.gather(*[stream(llm, i)
                                   for i in range(ASYNC_STREAMS)])
            wall = time.time() - t0
            if llm.core.has_work() or _pool_state(llm.core) != base:
                raise AssertionError(f"async: pools {_pool_state(llm.core)}")
            return wall, llm.core.steps_executed

    _reset_launches()
    wall, steps_n = asyncio.run(run())
    launches = {"async_streams": _launches()}
    http = serve_http.AsyncLLM(cfg, params, serve_http.demo_ecfg(),
                               detokenizer=serve_http.detok)
    _reset_launches()
    t0 = time.time()
    seen = asyncio.run(serve_http.selftest(http))
    http_wall = time.time() - t0
    launches["http_selftest"] = _launches()
    rec = dict(streams=ASYNC_STREAMS, aborted=len(aborted), wall_s=wall,
               steps=steps_n, step_ms=1e3 * wall / steps_n,
               sync_step_ms=sync_ms, http_wall_s=http_wall, http=seen)
    log(f"AsyncLLM: {ASYNC_STREAMS} streams ({len(aborted)} aborted after "
        f"their first chunk) in {wall:.3f} s over {steps_n} decode steps "
        f"({rec['step_ms']:.2f} ms a step; the synchronous LLM's run "
        f"{sync_ms:.2f} ms a step), the survivors = the synchronous LLM's "
        f"tokens, every page back; "
        f"launches { {k: v for k, v in launches['async_streams'].items() if v} }")
    log(f"HTTP selftest (serve_http, full-width weights): {http_wall:.3f} s, "
        f"200 / SSE / 400 / 408 ({seen['timeout_tokens']} tokens before "
        f"the timeout) / 429 / 500 / 503, {seen['metric_samples']} metric "
        f"samples, stats {seen['stats']}; launches "
        f"{ {k: v for k, v in launches['http_selftest'].items() if v} }")
    return launches, rec



# ----------------------------------------------------------- phase 21 ----
DEEPSEEK = "deepseek-moe-16b"   # MHA 16 heads, hd 128; dense FFN then 27 MoE
# Phase 21's continuous traffic: phase 6's first six prompts, 24 or 32 new
# tokens each; on 4 slots it still has mixed and all-STEADY steps, a
# CLUSTER a request and admissions after retirements, in about half of
# phase 6's decode steps (the script's time limit).
ZOO_TRAFFIC = (CONT_PROMPT_LENS[:6], (24, 32) * 3)
SIDE_ARCHS = ("qwen3-moe-30b-a3b", "internvl2-76b", "musicgen-large")


def _free():
    """Collect the engines of earlier runs and release the card's cache."""
    gc.collect()
    torch.cuda.empty_cache()


def gemma3_path():
    """Phase 21a: full-width gemma3-4b (34 layers, 5 of them global: 5,
    11, 17, 23, 29; window 1024; 8 heads over 4 KV groups, head_dim 320,
    qk_norm; bf16, random weights from a seed) through ``gemma2_path`` with
    every MHA baseline at full depth: the cohort (phase 5's traffic) and
    the continuous engine on ZOO_TRAFFIC, paged then dense, CHAI then the
    MHA baseline. The fused pair
    in its wide-head mode 5 times a step with a STEADY slot, the flash
    decode pair in its wide mode 5 times an MHA-baseline step, the local
    layers eager; paged == dense tokens; KV bytes unchanged at CLUSTER
    (GQA keeps its dense pages, as the reference does); empty pools.
    Returns ``gemma2_path``'s triple."""
    cfg, params = init_full_model(GEMMA3)
    ids = tuple(i for i, t in enumerate(cfg.layer_types)
                if t == "attn_global")
    if (cfg.n_layers, ids, cfg.window_size, cfg.head_dim) != (
            34, (5, 11, 17, 23, 29), 1024, ck.WIDE_HD):
        raise AssertionError(f"{GEMMA3}: layers {cfg.n_layers}, global "
                             f"{ids}, window {cfg.window_size}, head_dim "
                             f"{cfg.head_dim}")
    t0 = time.time()
    out = gemma2_path(cfg, params, label="gemma3", mha_depth=None,
                      traffic=ZOO_TRAFFIC)
    log(f"phase 21a (gemma3-4b, {cfg.n_layers} layers): "
        f"{time.time() - t0:.1f} s")
    del params
    _free()
    return out


class _FfnTimer:
    """Stands in for ``models.transformer._ffn``: while ``on``, CUDA events
    around each call, kept by kind (``dense`` or ``moe``, from the layer
    plan) with the form the MoE call took."""

    def __init__(self):
        self.inner, self.on, self.events = tfm._ffn, False, []

    def __call__(self, h, params, cfg, plan, i, moe_impl, aux=None):
        if not self.on:
            return self.inner(h, params, cfg, plan, i, moe_impl, aux)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.inner(h, params, cfg, plan, i, moe_impl, aux)
        b.record()
        kind = "dense" if plan["moe"][i] is None else f"moe_{moe_impl}"
        self.events.append((kind, a, b))
        return out


def _timed_step(core, timer):
    """One ``core.step()`` between CUDA events, its FFN calls timed
    (``timer``). Returns (step ms, {FFN kind: [ms a call]})."""
    timer.events.clear()
    timer.on = True
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    n0 = core.steps_executed
    a.record()
    try:
        core.step()
    finally:
        timer.on = False
    b.record()
    b.synchronize()
    if core.steps_executed != n0 + 1:
        raise AssertionError("the timed step decoded nothing")
    by_kind = {}
    for kind, x, y in timer.events:
        by_kind.setdefault(kind, []).append(x.elapsed_time(y))
    return a.elapsed_time(b), by_kind


def _step_copies(core, kind):
    """(device-to-host copies, device events) of the next decode step of
    ``core``, of ``kind`` ("steady": every occupied slot STEADY; "mixed":
    WARMUP and STEADY slots; "warmup": every occupied slot WARMUP, as
    without CHAI), from a whole ``torch.profiler`` trace: a
    step whose trace is not whole is followed by the next, with twice
    the sleep at the window's edges, up to PROFILE_TRIES steps, as
    ``_decode_step_copies`` does."""
    for _ in range(PROFILE_TRIES):
        n0 = core.steps_executed
        got = _profiled_copies(core.step, PROFILE_EDGE_S[0])
        phases = set(core._phases[core._phases
                                  != chai_cache.PHASE_FREE].tolist())
        want = {"steady": {chai_cache.PHASE_STEADY},
                "warmup": {chai_cache.PHASE_WARMUP},
                "mixed": {chai_cache.PHASE_WARMUP,
                          chai_cache.PHASE_STEADY}}[kind]
        if core.steps_executed != n0 + 1 or phases != want:
            raise AssertionError(f"the profiled step was no {kind} decode "
                                 f"step: phases {phases}")
        if got is not None:
            return got[0], got[1]
        PROFILE_EDGE_S[0] *= 2
    raise AssertionError(f"no whole profile of a {kind} decode step in "
                         f"{PROFILE_TRIES} tries")


def moe_step_profile(cfg, params):
    """Phase 21b's decode-step breakdown on a bare continuous paged
    engine, 3 requests in STEADY: one all-STEADY step (its MoE layers in
    the capacity form, the CHAI step's) and, after a fourth request is
    admitted, one mixed step (the ragged form), each between CUDA events
    with every FFN call timed: the MoE FFN's share of the step; then the
    device-to-host copies of the next step of each kind, counted as phase
    17c counts them (``_profiled_copies``). The capacity buffer reads
    every expert's weights a call: their bytes over the card's rate are
    logged beside the measured MoE call. Returns a summary dict."""
    core = EngineCore(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE))
    rng = np.random.default_rng(0)
    for n in CONT_PROMPT_LENS[:SLOTS - 1]:
        core.add_request(rng.integers(0, cfg.vocab_size, size=n),
                         SamplingParams(max_new_tokens=40))
    for _ in range(40):
        live = core._phases[:SLOTS - 1]
        if (live == chai_cache.PHASE_STEADY).all():
            break
        core.step()
    else:
        raise AssertionError("the requests never reached STEADY")
    timer = _FfnTimer()
    tfm._ffn = timer
    out = {}
    try:
        for kind in ("steady", "mixed"):
            if kind == "mixed":
                core.add_request(rng.integers(0, cfg.vocab_size, size=96),
                                 SamplingParams(max_new_tokens=16))
                core.step()             # admission, prefill, a mixed step
                phases = set(core._phases.tolist())
                if not {chai_cache.PHASE_WARMUP,
                        chai_cache.PHASE_STEADY} <= phases:
                    raise AssertionError(f"no mixed step: phases {phases}")
            step_ms, ffn = _timed_step(core, timer)
            copies, n_events = _step_copies(core, kind)
            moe_ms = sum(sum(v) for k, v in ffn.items() if k != "dense")
            out[kind] = dict(
                step_ms=step_ms, ffn_ms={k: sum(v) for k, v in ffn.items()},
                moe_layer_ms=statistics.mean(
                    x for k, v in ffn.items() if k != "dense" for x in v),
                moe_share=moe_ms / step_ms, copies=copies,
                device_events=n_events)
            log(f"{cfg.name} {kind} decode step: {step_ms:.2f} ms between "
                f"events; FFN calls by kind (ms, sum): "
                f"{ {k: round(sum(v), 3) for k, v in ffn.items()} }; the "
                f"MoE FFN {moe_ms:.2f} ms = {100 * moe_ms / step_ms:.1f}% of "
                f"the step ({out[kind]['moe_layer_ms']:.3f} ms a MoE layer);"
                f" the next {kind} step: {copies} device-to-host copies, "
                f"{n_events} device events")
    finally:
        tfm._ffn = timer.inner
        for r in list(core._slot_req):
            if r is not None:
                core.abort(r.uid)
    every = (3 * cfg.d_model * cfg.moe_d_ff * cfg.n_experts
             * tfm.model_dtype(cfg).itemsize)
    log(f"{cfg.name}: the capacity form reads every expert's weights a "
        f"call, {every:,} B a MoE layer = "
        f"{every / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s, against "
        f"{out['steady']['moe_layer_ms']:.3f} ms measured a MoE layer of "
        "the all-STEADY step")
    out["expert_bytes_a_layer"] = every
    return out


def moe_serving_path(cfg, params, label):
    """Phases 21b and 21c: the continuous paged engine on ZOO_TRAFFIC,
    CHAI then the MHA baseline: the CHAI run launches
    ``paged_chai_fused_decode`` n_layers times a mixed or all-STEADY step
    and nothing else; the baseline ``paged_decode`` n_layers times a step
    and nothing else, the eager decode attention never; every pick's
    logits finite and of the vocabulary's width (``_check_logits``); KV
    bytes falling at every CLUSTER on an MHA model (its K pages go to the
    clustered pool), unchanged on a GQA one; the pools empty after each
    run. Returns ({path: launches}, {run: _run_summary})."""
    t0 = time.time()
    run = serve_continuous(cfg, params, "paged", traffic=ZOO_TRAFFIC)
    calls = run["calls"]
    _check_served(cfg, run, label)
    want = {k: 0 for k in run["launches"]}
    want["paged_chai_fused_decode"] = cfg.n_layers * (
        calls["mixed_step"] + calls["steady_step"])
    if run["launches"] != want:
        raise AssertionError(f"{label}: launches {run['launches']}, "
                             f"expected {want}")
    _check_wide(cfg, run["launches"], label)
    _log_served(run, label)
    (_check_kv_bytes if cfg.is_mha else _check_gqa_kv_bytes)(run, label)
    chai = _run_summary(run)
    launches = {label: run["launches"]}
    run.clear()
    _free()
    EAGER["calls"] = 0
    m_run = serve_continuous(cfg, params, "paged", use_chai=False,
                             traffic=ZOO_TRAFFIC)
    m_calls = m_run["calls"].get("mha_step", 0)
    m_want = {k: 0 for k in m_run["launches"]}
    m_want["paged_decode"] = cfg.n_layers * m_calls
    if (m_run["launches"] != m_want or EAGER["calls"] or not m_calls
            or m_run["eng"].dense_pool.pages_in_use
            or m_run["eng"].chai_pool is not None):
        raise AssertionError(f"{label} MHA baseline: launches "
                             f"{m_run['launches']}, expected {m_want}; eager "
                             f"calls {EAGER['calls']}; pages in use "
                             f"{m_run['eng'].dense_pool.pages_in_use}")
    _log_served(m_run, f"{label} MHA baseline")
    mha = _run_summary(m_run)
    launches[f"{label}_mha"] = m_run["launches"]
    m_run.clear()
    _free()
    log(f"{label} ({cfg.n_layers} layers): CHAI {chai['tok_s']:.1f} tok/s "
        f"(wall {chai['wall_s']:.3f} s, TTFT mean "
        f"{chai['ttft_mean_s']:.4f} s, step ms {chai['step_ms']}), MHA "
        f"baseline {mha['tok_s']:.1f} tok/s (wall {mha['wall_s']:.3f} s, "
        f"step ms {mha['step_ms']}); both runs {time.time() - t0:.1f} s")
    return launches, dict(chai=chai, mha=mha)


def moe_paths():
    """Phase 21b: full-width deepseek-moe-16b at full depth (28 layers;
    32.8 GB in bf16: every earlier model freed first) through
    ``moe_serving_path`` and ``moe_step_profile``. Phase 21c:
    qwen3-moe-30b-a3b, internvl2-76b and musicgen-large at SIDE_DEPTH,
    full widths, their weights made at the cut config directly, each
    through ``moe_serving_path``. Returns ({path: launches}, {arch:
    summaries})."""
    launches, sums = {}, {}
    t0 = time.time()
    cfg, params = init_full_model(DEEPSEEK)
    if (cfg.n_layers, cfg.n_dense_ffn, cfg.n_moe_ffn, cfg.n_heads,
            cfg.head_dim) != (28, 1, 27, 16, 128) or not cfg.is_mha:
        raise AssertionError(f"{DEEPSEEK}: {cfg}")
    got, sums[DEEPSEEK] = moe_serving_path(cfg, params, "deepseek")
    launches.update(got)
    sums[DEEPSEEK]["step_profile"] = moe_step_profile(cfg, params)
    del params
    _free()
    log(f"phase 21b ({DEEPSEEK}): {time.time() - t0:.1f} s")
    for arch in SIDE_ARCHS:
        t0 = time.time()
        cfg, params = init_full_model(arch, n_layers=SIDE_DEPTH)
        tag = arch.split("-")[0]
        got, sums[arch] = moe_serving_path(cfg, params, f"{tag}_side")
        launches.update(got)
        del params
        _free()
        log(f"phase 21c ({arch}, {SIDE_DEPTH} layers): "
            f"{time.time() - t0:.1f} s")
    return launches, sums


# ----------------------------------------------------------- phase 22 ----
# The recurrent state on the card: a prompt of STATE_PROMPT tokens, its
# own bucket (no padding reaches the recurrence), then STATE_NEW greedy
# decode steps, against one forward over the prompt and the generated
# tokens, in fp32 on the model's weights (each leaf cast up) and in the
# model's bf16. The two sides round at different places (the RG-LRU scan
# against its step, the RWKV chunk against its step, a whole-prompt
# attention against a decode one, products of other shapes). In fp32
# (TF32 off) they part in the last bits: the logits (std ~1) are held at
# STATE_F32_TOL and the greedy token wherever the forward's top-2 margin
# exceeds STATE_F32_MARGIN. In bf16 the recurrent state is stored in the
# model dtype after every decode step but carried in fp32 through a
# prefill, as in the reference, so the sides drift apart step by step:
# a first run on the H100 measured a max |diff| of 0.38 (recurrentgemma)
# and 1.10 (rwkv), a mean of 0.053 and 0.131, and greedy tokens parting
# at margins up to 0.16; a decode that lost its state would part by the
# difference of two unrelated N(0, 1) logits, a mean of 1.13. So bf16 is
# held at STATE_BF16_MAX and STATE_BF16_MEAN, its greedy agreement
# logged.
STATE_PROMPT = 64
STATE_NEW = 16
STATE_F32_TOL = 1e-3
STATE_F32_MARGIN = 2e-3
STATE_BF16_MAX = 2.0
STATE_BF16_MEAN = 0.25


def recurrent_state_rows(cfg, params):
    """(engine rows, forward rows, generated tokens): STATE_PROMPT tokens
    served alone by the continuous engine with ``use_chai=False`` (CHAI's
    clustered attention is not the forward's), STATE_NEW + 1 new tokens,
    the logits of the prefill and of each decode step (fp32, (STATE_NEW +
    1, V)); and the same positions' logits from one ``forward_fullseq``
    over the prompt and the first STATE_NEW generated tokens, right-padded
    to a multiple of the RWKV chunk (the forward is causal: the padding
    moves no compared position). No kernel may launch."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=STATE_PROMPT)
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=1, max_seq=MAX_SEQ, page_size=PAGE, use_chai=False))
    if eng._prompt_bucket(STATE_PROMPT, MAX_SEQ) != STATE_PROMPT:
        raise AssertionError(f"{cfg.name}: the state check's prompt is "
                             "padded")
    rows, argmax = [], eng._argmax

    def rec(logits):
        rows.append(logits[0].float().clone())
        return argmax(logits)
    eng._argmax = rec
    eng.submit(prompt, max_new_tokens=STATE_NEW + 1, uid=0)
    _reset_launches()
    gen = eng.run()[0].generated
    seq = list(prompt) + gen[:STATE_NEW]
    t = -(-len(seq) // rwkv_mod.CHUNK) * rwkv_mod.CHUNK
    toks = torch.zeros((1, t), dtype=torch.long, device="cuda")
    toks[0, :len(seq)] = torch.tensor(seq, device="cuda")
    logits, _ = tfm.forward_fullseq(params, cfg, toks)
    if any(_launches().values()):
        raise AssertionError(f"{cfg.name} state check: launches "
                             f"{_launches()}")
    want = logits[0, STATE_PROMPT - 1:STATE_PROMPT + STATE_NEW].float()
    return torch.stack(rows), want, gen


def recurrent_state_check(cfg, params, label):
    """The recurrent state of one request on the card
    (``recurrent_state_rows``), in the model's bf16 and in fp32 on the same
    weights (each leaf cast up): every logit finite; fp32: the engine's
    logits within STATE_F32_TOL of the forward's and the greedy token equal
    on every step whose top-2 margin exceeds STATE_F32_MARGIN; bf16: the
    max and the mean |diff| within STATE_BF16_MAX and STATE_BF16_MEAN.
    Returns {dtype: summary}."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        if dtype == cfg.dtype:
            c, p = cfg, params
        else:
            c = cfg.replace(dtype=dtype)
            p = {g: {n: t.to(getattr(torch, dtype)) for n, t in grp.items()}
                 for g, grp in params.items()}
        got, want, _ = recurrent_state_rows(c, p)
        del p
        _free()
        f32 = dtype == "float32"
        atol = STATE_F32_TOL if f32 else STATE_BF16_MAX
        margin = STATE_F32_MARGIN if f32 else math.inf
        diff = (got - want).abs()
        row_err = diff.amax(-1)
        top2 = want.topk(2, dim=-1).values
        gaps = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        checked = gaps > margin
        err = float(diff.max())
        rec = dict(max_abs=err, mean_abs=float(diff.mean()),
                   row_max_abs=[round(x, 6) for x in row_err.tolist()],
                   margins=[round(x, 6) for x in gaps.tolist()],
                   equal=int(same.sum()), checked=int(checked.sum()),
                   rows=len(got), logit_std=float(want.std()))
        out[dtype] = rec
        log(f"{label} recurrent state on the card, {dtype}: a "
            f"{STATE_PROMPT}-token prompt (its own bucket) + {STATE_NEW} "
            f"greedy decode steps against one forward: logits max abs diff "
            f"{err:.5f} (limit {atol}), mean {rec['mean_abs']:.6f}"
            f"{'' if f32 else f' (limit {STATE_BF16_MEAN})'}, the "
            f"forward's logit std {rec['logit_std']:.4f}; per row max "
            f"{rec['row_max_abs']}; top-2 margins {rec['margins']}; greedy "
            f"equal on {rec['equal']} of {len(got)}, {rec['checked']} "
            f"margin-checked (> {margin})")
        if (not torch.isfinite(got).all() or not torch.isfinite(want).all()
                or err > atol or not same[checked].all()
                or (not f32 and rec["mean_abs"] > STATE_BF16_MEAN)):
            raise AssertionError(f"{label} state check, {dtype}: logits max "
                                 f"abs diff {err:.5f} (limit {atol}), mean "
                                 f"{rec['mean_abs']:.5f}; greedy "
                                 f"equal {same.tolist()} where margins "
                                 f"{gaps.tolist()} (checked above {margin})")
    return out


def recurrent_step_copies(cfg, params, chai):
    """(device-to-host copies, device events) of one decode step of a bare
    continuous engine with SLOTS - 1 requests decoding: all STEADY with
    CHAI, all WARMUP (the phase a slot keeps without CHAI) otherwise
    (``_step_copies``)."""
    core = EngineCore(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE, use_chai=chai))
    rng = np.random.default_rng(0)
    for n in CONT_PROMPT_LENS[:SLOTS - 1]:
        core.add_request(rng.integers(0, cfg.vocab_size, size=n),
                         SamplingParams(max_new_tokens=40))
    want = chai_cache.PHASE_STEADY if chai else chai_cache.PHASE_WARMUP
    try:
        for _ in range(40):
            if (core._phases[:SLOTS - 1] == want).all():
                break
            core.step()
        else:
            raise AssertionError(f"{cfg.name}: the requests never reached "
                                 f"phase {want}")
        return _step_copies(core, "steady" if chai else "warmup")
    finally:
        for r in list(core._slot_req):
            if r is not None:
                core.abort(r.uid)


def recurrent_layer_ms(cfg, params, t):
    """CUDA-event times (``time_ms``: 20 calls back to back) of the first
    recurrent layer's mixer: its prefill over a batch-1 bucket of ``t``
    tokens (RG-LRU: the conv and the doubling scan, ceil(log2 t) rounds;
    RWKV: the time mix's loop over t / 32 chunks), and its decode step
    over SLOTS rows. No kernel launched. Returns {kind: ms}."""
    plan = tfm.layer_plan(cfg)
    i = next(j for j in range(cfg.n_layers) if plan["attn"][j] is None)
    gen = torch.Generator("cuda").manual_seed(2)
    dt = tfm.model_dtype(cfg)
    x = torch.randn((1, t, cfg.d_model), generator=gen, device="cuda").to(dt)
    x1 = torch.randn((SLOTS, cfg.d_model), generator=gen,
                     device="cuda").to(dt)
    st1 = tfm.init_decode_state(cfg, 1, MAX_SEQ, "cuda")
    st4 = tfm.init_decode_state(cfg, SLOTS, MAX_SEQ, "cuda")
    _reset_launches()
    out = {"prefill_ms": time_ms(lambda: tfm._recurrent_mixer(
               x, params, cfg, plan, i, st1)),
           "decode_ms": time_ms(lambda: tfm._recurrent_mixer(
               x1, params, cfg, plan, i, st4, step=True))}
    if any(_launches().values()):
        raise AssertionError(f"{cfg.name} layer timing launched kernels")
    kind = "RG-LRU" if plan["rec"][i] is not None else "RWKV time-mix"
    log(f"{cfg.name} layer {i} ({kind}) by CUDA events: prefill of a "
        f"{t}-token bucket {out['prefill_ms']:.4f} ms, a decode step of "
        f"{SLOTS} rows {out['decode_ms']:.4f} ms")
    return out


def recurrent_path(arch):
    """Phase 22 for one recurrent arch at full width and full depth, its
    weights from ``init_full_model``: the cohort on phase 5's traffic
    (CHAI then the MHA baseline through ``local_cohort`` where CHAI
    applies, the baseline alone on rwkv), then the continuous engine on
    ZOO_TRAFFIC with ``kv_layout="paged"`` (the default), which runs the
    unified dense layout without global layers: CHAI twice (the repeat
    bit for bit: tokens and every top-2 margin) and the MHA baseline
    where CHAI applies, the baseline twice on rwkv, whose engine refuses
    ``use_chai=True``. Every logit finite; no kernel launched by any run;
    the eager decode attention once an attention layer a baseline step;
    ``kv_bytes()`` the rings only. Then the device-to-host copies of one
    decode step, the first recurrent layer's prefill and decode times,
    and ``recurrent_state_check``. Returns ({path: launches},
    summary)."""
    t0 = time.time()
    cfg, params = init_full_model(arch)
    chai = chai_applies(cfg)
    tag = "rg" if arch == RG else "rwkv"
    if arch == RG:
        if (cfg.n_layers, cfg.n_rec_layers, cfg.n_local_layers,
                cfg.n_global_layers, cfg.n_kv_heads) != (38, 26, 12, 0, 1):
            raise AssertionError(f"{arch}: {cfg}")
    elif (cfg.n_layers, cfg.n_rwkv_layers, cfg.n_attn_layers) != (24, 24, 0):
        raise AssertionError(f"{arch}: {cfg}")
    launches, out = {}, {}
    start = _memory_start()
    if chai:
        got, cohort = local_cohort(cfg, params, f"{tag}_cohort")
        launches.update(got)
        cohort = {k: v for k, v in cohort.items()
                  if k not in ("membership", "margins", "tokens")}
    else:
        _reset_launches()
        eng, done, wall, phases, _ = serve_local(cfg, params, False,
                                                 PROMPT_LENS, MAX_SEQ)
        launches[f"{tag}_cohort_mha"] = _launches()
        counts = [len(r.generated) for r in done]
        if counts != [MAX_NEW] * len(PROMPT_LENS):
            raise AssertionError(f"{tag} cohort: token counts {counts}")
        n_tok = sum(counts)
        cohort = dict(mha_wall_s=wall, mha_tok_s=n_tok / wall,
                      ttft_mean_s=statistics.mean(r.ttft for r in done),
                      phase_s=phases,
                      mha_step_ms=1e3 * phases["mha_decode"]
                      / eng.steps_executed)
        busy = {k: n for k, n in launches[f"{tag}_cohort_mha"].items() if n}
        log(f"{tag} cohort (no CHAI): {n_tok / wall:.1f} tok/s in "
            f"{wall:.3f} s, {eng.steps_executed} decode steps, launches "
            f"{busy}; by phase " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in phases.items()))
        del eng
    cohort["device_peak_run"] = torch.cuda.max_memory_allocated() - start
    out["cohort"] = cohort
    if not chai:
        try:
            ServingEngine(cfg, params, EngineConfig(
                batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE))
        except ValueError as e:
            if "CHAI needs attention layers" not in str(e):
                raise
        else:
            raise AssertionError(f"{arch}: use_chai=True served without "
                                 "attention layers")
    runs = {}
    names = (("chai", True), ("chai_repeat", True), ("mha", False)) if chai \
        else (("mha", False), ("mha_repeat", False))
    for name, use in names:
        label = f"{tag} continuous {name}"
        EAGER["calls"] = 0
        run = serve_continuous(cfg, params, "paged", use_chai=use,
                               traffic=ZOO_TRAFFIC)
        if run["eng"].paged:
            raise AssertionError(f"{label}: a paged layout without global "
                                 "layers")
        _check_served(cfg, run, label)
        if use:
            want = {k: 0 for k in run["launches"]}
        else:
            want, eager = local_mha_want(cfg, "paged",
                                         run["calls"].get("mha_step", 0),
                                         run["launches"])
            if EAGER["calls"] != eager:
                raise AssertionError(f"{label}: eager calls "
                                     f"{EAGER['calls']}, expected {eager}")
        if run["launches"] != want:
            raise AssertionError(f"{label}: launches {run['launches']}")
        _log_served(run, label)
        _check_local_kv_bytes(cfg, run, "dense")
        launches[f"{tag}_continuous_{name}"] = run["launches"]
        runs[name] = dict(summary=_run_summary(run), margins=run["margins"])
        run.clear()
        _free()
    first, again = names[0][0], names[1][0]
    if (runs[first]["summary"]["tokens"] != runs[again]["summary"]["tokens"]
            or runs[first]["margins"] != runs[again]["margins"]):
        raise AssertionError(f"{tag}: the repeated continuous run differs")
    log(f"{tag} continuous {first}: the repeat gave the same tokens and "
        f"the same top-2 margins, bit for bit")
    out.update({name: r["summary"] for name, r in runs.items()})
    copies, n_events = recurrent_step_copies(cfg, params, chai)
    if copies != 1:
        raise AssertionError(f"{tag}: {copies} device-to-host copies in a "
                             "decode step, expected 1 (the tokens)")
    log(f"{tag} decode step ({'all STEADY' if chai else 'no CHAI'}): "
        f"{copies} device-to-host copy, {n_events} device events")
    out["step_copies"], out["step_events"] = copies, n_events
    bucket = ServingEngine._prompt_bucket(max(ZOO_TRAFFIC[0]), MAX_SEQ)
    out["layer_ms"] = recurrent_layer_ms(cfg, params, bucket)
    out["state_check"] = recurrent_state_check(cfg, params, tag)
    del params
    _free()
    out["seconds"] = time.time() - t0
    log(f"phase 22 ({arch}, {cfg.n_layers} layers): {out['seconds']:.1f} s")
    return launches, out


def recurrent_paths():
    """Phase 22: recurrentgemma-9b (10.45 B parameters, 20.9 GB in bf16)
    then rwkv6-1.6b, each through ``recurrent_path`` after every earlier
    model is freed; no kernel launched over any of their runs. Returns
    ({path: launches}, {arch: summary})."""
    launches, sums = {}, {}
    for arch in (RG, RWKV):
        got, sums[arch] = recurrent_path(arch)
        launches.update(got)
    busy = {p: {k: n for k, n in c.items() if n} for p, c in launches.items()
            if any(c.values())}
    if busy:
        raise AssertionError(f"phase 22 launched kernels: {busy}")
    log(f"phase 22: none of the 13 kernels launched over "
        f"{len(launches)} runs: {sorted(launches)}")
    return launches, sums


# ----------------------------------------------------------- phase 23 ----
# The training stack (ROADMAP #15). No TPU kernel is on the training path:
# the reference trains through its jnp attention and no Pallas kernel has
# a backward, so the port's backward is autograd over its torch ops and
# the 13 kernels' counters stay 0 over every training run. 23c serves the
# trained weights through the kernels.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 20
# The trainer's default schedule for TRAIN_STEPS steps.
TRAIN_LR = dict(total=TRAIN_STEPS, warmup=max(2, TRAIN_STEPS // 10))
# Fused against two microbatches, bf16: the losses are means over other
# groupings of the same tokens; each leaf's first moment (0.1 x its
# clipped gradient) sums bf16 gradients of half batches, held at this
# share of the leaf's largest entry (bf16 keeps 8 bits).
MICRO_LOSS_RTOL, MICRO_MOMENT_TOL = 5e-3, 3e-2
RESUME_DEPTH, RESUME_STEPS = 2, 10
# The tiny model of tests/test_system.py, trained on the card, and the
# prompts its accuracy check serves. The test serves 4 prompts of 16 new
# tokens; a request's agreement with MHA is near 1 or near 0.4 (once a
# token parts, the greedy continuations part), so one representative tie
# in a two-head cluster (ROADMAP "Two-head cluster ties") moves the
# 4-prompt share by 0.09. The check holds 32 prompts (512 tokens) and
# logs the first 4's share beside it.
TINY_KW = dict(n_layers=2, d_model=64, n_heads=8, d_ff=128, vocab=128)
TINY_PROMPTS = 32


def _kernels_idle(launches, label):
    busy = {k: n for k, n in launches.items() if n}
    if busy:
        raise AssertionError(f"{label}: kernels launched: {busy}")


def train_flops(cfg, tokens, seq):
    """Matmul FLOPs of one forward over ``tokens`` tokens in sequences of
    ``seq``: two a multiply-add of the q/k/v/o projections, the FFN, the
    unembed, and attention's two products over every (query, key) pair
    (the port's full-sequence attention computes the masked half too)."""
    d, hd = cfg.d_model, cfg.head_dim
    proj = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    ffn = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    attn = 2 * seq * cfg.n_heads * hd
    return 2 * tokens * (cfg.n_layers * (proj + ffn + attn)
                         + d * cfg.vocab_size)


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def train_step_path(smi):
    """Phase 23a: full-width chai-llama-7b at SIDE_DEPTH layers (bf16,
    remat) on TRAIN_BATCH x TRAIN_SEQ tokens of the port's pipeline. The
    fused step against two microbatches on batch 0; then TRAIN_STEPS
    fused steps, the loss falling by more than 0.3; per step the device
    time of forward + backward and of the optimizer (CUDA events around
    ``adamw.update``), the host wall, the device memory peak. No kernel
    launches. Returns a summary."""
    t0 = time.time()
    cfg, params = init_full_model(ARCH, n_layers=SIDE_DEPTH)
    if ((cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size, cfg.n_layers,
         cfg.dtype) != (4096, 32, 11008, 32000, SIDE_DEPTH, "bfloat16")):
        raise AssertionError(f"phase 23a config {cfg}")
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
    fused = steps.make_train_step(cfg, remat=True, lr_kw=TRAIN_LR)
    micro = train_step_mod.make_microbatched_train_step(
        cfg, n_micro=2, remat=True, lr_kw=TRAIN_LR)
    opt = adamw.init(params)
    batch = pipe.global_batch_tensor(0, "cuda")
    _reset_launches()
    p1, o1, m1 = fused(params, opt, batch)
    m_fused = o1.m
    del p1, o1
    p2, o2, m2 = micro(params, opt, batch)
    worst = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                for a, b in zip(adamw.tree_leaves(m_fused),
                                adamw.tree_leaves(o2.m)))
    d_loss = abs(float(m1["loss"]) - float(m2["loss"])) / float(m1["loss"])
    lr_same = m1["lr"].cpu().numpy().tobytes() == m2["lr"].cpu().numpy(
        ).tobytes()
    if (d_loss > MICRO_LOSS_RTOL or worst > MICRO_MOMENT_TOL or not lr_same
            or int(o2.step) != 1):
        raise AssertionError(
            f"phase 23a fused vs microbatched: loss {float(m1['loss'])} / "
            f"{float(m2['loss'])}, first moments {worst:.3e} of a leaf's "
            f"largest, lr equal {lr_same}")
    log(f"phase 23a fused vs 2 microbatches, batch 0: loss "
        f"{float(m1['loss']):.6f} / {float(m2['loss']):.6f} (rel "
        f"{d_loss:.2e}, limit {MICRO_LOSS_RTOL}), grad norm "
        f"{float(m1['grad_norm']):.6f} / {float(m2['grad_norm']):.6f}, "
        f"first moments within {worst:.3e} of each leaf's largest (limit "
        f"{MICRO_MOMENT_TOL}), lr bitwise equal")
    del p2, o2, m_fused
    _free()
    marks, update = [], adamw.update

    def timed_update(*args, **kw):
        e1 = _event()
        out = update(*args, **kw)
        marks.append((e1, _event()))
        return out
    adamw.update = timed_update
    losses, walls, starts = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(TRAIN_STEPS):
            batch = pipe.global_batch_tensor(i, "cuda")
            w0 = time.perf_counter()
            starts.append(_event())
            params, opt, m = fused(params, opt, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - w0)
    finally:
        adamw.update = update
    torch.cuda.synchronize()
    launches = _launches()
    _kernels_idle(launches, "phase 23a")
    peak = torch.cuda.max_memory_allocated()
    fb = [s.elapsed_time(e1) for s, (e1, _) in zip(starts, marks)]
    up = [e1.elapsed_time(e2) for e1, e2 in marks]
    step = statistics.median(a + b for a, b in zip(fb[2:], up[2:]))
    if (not all(math.isfinite(x) for x in losses)
            or losses[-1] > losses[0] - 0.3 or int(opt.step) != TRAIN_STEPS):
        raise AssertionError(f"phase 23a losses {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fwd = train_flops(cfg, tokens, TRAIN_SEQ)
    out = dict(n_params=n_params, losses=losses,
               step_ms=step, fwd_bwd_ms=statistics.median(fb[2:]),
               optimizer_ms=statistics.median(up[2:]),
               wall_ms=1e3 * statistics.median(walls[2:]),
               tokens_s=tokens / (step / 1e3), peak_bytes=peak,
               model_flop_share=3 * fwd / (step / 1e3) / BF16_FLOPS,
               remat_flop_share=4 * fwd / (step / 1e3) / BF16_FLOPS,
               state_bytes=n_params * (2 + 4 + 4))
    log(f"phase 23a ({smi}): {cfg.name}, {cfg.n_layers} layers at full "
        f"width, {n_params / 1e9:.3f} B params (bf16 weights, fp32 "
        f"moments: {out['state_bytes'] / 1e9:.2f} GB), {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, remat; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {TRAIN_STEPS} steps ({losses})")
    log(f"phase 23a ({smi}): median of steps 3-{TRAIN_STEPS}: step "
        f"{step:.2f} ms on the device (forward + backward "
        f"{out['fwd_bwd_ms']:.2f}, optimizer {out['optimizer_ms']:.2f}: "
        f"{100 * out['optimizer_ms'] / step:.1f}%), host wall "
        f"{out['wall_ms']:.2f} ms; {out['tokens_s']:.0f} tokens/s; model "
        f"FLOP/s {3 * fwd / (step / 1e3) / 1e12:.1f} T "
        f"({100 * out['model_flop_share']:.2f}% of {BF16_FLOPS / 1e12:.0f} "
        f"T; {100 * out['remat_flop_share']:.2f}% counting the remat "
        f"recompute); device memory peak {peak:,} B; steps "
        f"{[round(a + b, 2) for a, b in zip(fb, up)]} ms; "
        f"{time.time() - t0:.1f} s")
    del params, opt
    _free()
    return {"train_step": launches}, out


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def resume_path(smi, root):
    """Phase 23b: chai-llama-7b at full width and RESUME_DEPTH layers
    through ``Trainer`` (bf16, remat; the pipeline's batches): 10 steps
    straight (the trainer's step, no save) against ``run`` for 5 steps
    and its save, and a fresh ``Trainer`` whose ``run`` restores it and
    runs 5 more. The final losses at rtol 1e-5 and every
    leaf's max abs difference; GB written, seconds to save and to
    restore. Returns (cfg, the resumed run's final params, its checkpoint
    directory, summary)."""
    t0 = time.time()
    cfg = cut_config(get_config(ARCH), RESUME_DEPTH)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    kw = dict(total_steps=RESUME_STEPS, log_every=1000, keep=1)
    saves, restores = [], []

    def trainer(name, every):
        tr = Trainer(cfg, data, TrainerConfig(
            ckpt_every=every, ckpt_dir=os.path.join(root, name), **kw))
        save, restore = tr.ckpt.save, tr.ckpt.restore

        def timed_save(*a, **k):
            w0 = time.perf_counter()
            out = save(*a, **k)
            saves.append((time.perf_counter() - w0, _dir_bytes(out)))
            return out

        def timed_restore(*a, **k):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            out = restore(*a, **k)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - w0)
            return out
        tr.ckpt.save, tr.ckpt.restore = timed_save, timed_restore
        return tr

    _reset_launches()
    tr = trainer("a", 1000)
    straight = tr.init_state()
    for step in range(RESUME_STEPS):   # the trainer's step, no save
        straight, m_straight = tr._one_step(
            straight, tr.pipe.global_batch_tensor(step, "cuda"))
    del straight["opt"], tr
    _free()
    trainer("b", RESUME_STEPS // 2).run(max_steps=RESUME_STEPS // 2)
    _free()
    resumed, m_resumed = trainer("b", RESUME_STEPS // 2).run()
    _kernels_idle(_launches(), "phase 23b")
    a, b = float(m_straight["loss"]), float(m_resumed["loss"])
    diffs = {f"{g}/{n}": float((t.float() - resumed["params"][g][n].float()
                                ).abs().max())
             for g, grp in straight["params"].items()
             for n, t in grp.items()}
    if abs(a - b) > 1e-5 * abs(a) or len(restores) != 1 or len(saves) != 2:
        raise AssertionError(f"phase 23b: final loss straight {a}, resumed "
                             f"{b}; saves {len(saves)}, restores "
                             f"{len(restores)}")
    gb = saves[-1][1] / 1e9
    out = dict(loss_straight=a, loss_resumed=b, leaf_max_abs_diff=diffs,
               save_gb=gb, save_s=[s for s, _ in saves],
               restore_s=restores[0], deterministic_algorithms=False)
    log(f"phase 23b ({smi}): {cfg.name} {cfg.n_layers} layers at full "
        f"width, {RESUME_STEPS} steps straight: final loss {a:.6f}; 5 + "
        f"save + restore + 5: {b:.6f}; every leaf's max abs difference (torch "
        f"deterministic algorithms off): {diffs}")
    log(f"phase 23b ({smi}): a save {gb:.3f} GB (params and AdamW state), "
        f"saves {[round(s, 3) for s, _ in saves]} s "
        f"({gb / statistics.median(s for s, _ in saves):.3f} GB/s, fsync "
        f"included), the restore {restores[0]:.3f} s "
        f"({gb / restores[0]:.3f} GB/s, to the card, a warm read); "
        f"{time.time() - t0:.1f} s")
    del straight
    _free()
    return cfg, resumed["params"], os.path.join(root, "b"), out


def train_serve_path(smi, cfg, params, ckpt_dir):
    """Phase 23c, first half: 23b's last checkpoint restored (its params)
    and served by the continuous paged engine on ZOO_TRAFFIC, against the
    in-memory params on the same traffic: the restored weights bit for
    bit, the same tokens, ``paged_chai_fused_decode`` n_layers times a
    mixed or all-STEADY step. Returns {path: launches}."""
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    restored, extra = mgr.restore(step, {"params": params})
    restored = restored["params"]
    if (step != RESUME_STEPS or extra != {"data_batch": RESUME_STEPS}
            or not all(torch.equal(x, y) for x, y in zip(
                adamw.tree_leaves(params), adamw.tree_leaves(restored)))):
        raise AssertionError(f"phase 23c: restored step {step}, {extra}")
    launches, toks = {}, {}
    for name, p in (("restored", restored), ("memory", params)):
        run = serve_continuous(cfg, p, "paged", traffic=ZOO_TRAFFIC)
        _check_served(cfg, run, f"trained_{name}")
        calls = run["calls"]
        want = {k: 0 for k in run["launches"]}
        want["paged_chai_fused_decode"] = cfg.n_layers * (
            calls["mixed_step"] + calls["steady_step"])
        if run["launches"] != want:
            raise AssertionError(f"phase 23c {name}: launches "
                                 f"{run['launches']}, expected {want}")
        _log_served(run, f"trained ({name} params)")
        launches[f"trained_served_{name}"] = run["launches"]
        toks[name] = [r.generated for r in run["done"]]
        run.clear()
        _free()
    if toks["restored"] != toks["memory"]:
        raise AssertionError("phase 23c: restored and in-memory tokens differ")
    log(f"phase 23c ({smi}): the checkpoint of step {step} served on "
        f"ZOO_TRAFFIC gave the in-memory params' tokens "
        f"({sum(map(len, toks['memory']))} tokens); fused pair launches "
        f"{launches['trained_served_restored']['paged_chai_fused_decode']}")
    return launches


def _served_tiny(cfg, params, pipe, use_chai, identify=None):
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=2, max_seq=128, use_chai=use_chai))
    if identify is not None:
        eng._identify = identify
    for i in range(TINY_PROMPTS):
        eng.submit(pipe.batch(100 + i)["tokens"][0, :24], max_new_tokens=16,
                   uid=i)
    _reset_launches()
    done = eng.run()
    return {r.uid: r.generated for r in done}, _launches()


def trained_tiny_path(smi, root):
    """Phase 23c, second half: the tiny model of ``tests/test_system.py``
    trained on the card for 60 steps, the offline elbow run on its
    activations (``calibration_batches``), then TINY_PROMPTS prompts
    served by the continuous paged engine: MHA (``paged_decode``), CHAI at k 6 and 4 (the fused pair)
    and round-robin membership at k 4 (``clustering.shared_ctx``); CHAI's
    greedy agreement with MHA above 0.7, and CHAI at k 4 at least
    round-robin's less 0.05 (the paper's Fig 1 baseline). Returns
    ({path: launches}, summary)."""
    t0 = time.time()
    cfg = reduced(get_config(ARCH), **TINY_KW).replace(dtype="float32")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    tr = Trainer(cfg, data, TrainerConfig(
        total_steps=60, ckpt_every=1000, log_every=1000,
        ckpt_dir=os.path.join(root, "tiny"),
        lr_kw=dict(peak=3e-3, warmup=6, total=60)))
    state, metrics = tr.run()
    loss = float(metrics["loss"])
    params, pipe = state["params"], tr.pipe
    elbow = offline_clustering.offline_phase(
        params, cfg, calibration_batches(cfg.vocab_size, 32, 8),
        device="cuda")
    if (len(elbow["counts"]) != cfg.n_attn_layers
            or not all(1 <= k <= cfg.n_heads for k in elbow["counts"])):
        raise AssertionError(f"phase 23c elbow counts {elbow['counts']}")
    mha, l_mha = _served_tiny(cfg, params, pipe, False)
    runs, launches = {}, {"tiny_trained_mha": l_mha}
    for k in (6, 4):
        cfg_k = cfg.with_chai(enabled=True, cluster_counts=(k, k))
        runs[k], launches[f"tiny_trained_chai_k{k}"] = _served_tiny(
            cfg_k, params, pipe, True)
    rand = clustering.shared_ctx(cfg_k, device="cuda")
    rr, launches["tiny_trained_round_robin_k4"] = _served_tiny(
        cfg_k, params, pipe, True,
        identify=lambda sc: {n: v[:, None] for n, v in rand.items()})

    def agree(gen, n=TINY_PROMPTS):
        return float(np.mean([np.mean(np.asarray(mha[u])
                                      == np.asarray(gen[u]))
                              for u in range(n)]))
    out = dict(loss=loss, elbow_counts=elbow["counts"],
               elbow_offdiag=elbow["offdiag"],
               chai6=agree(runs[6]), chai4=agree(runs[4]),
               round_robin4=agree(rr), chai6_first4=agree(runs[6], 4),
               chai4_first4=agree(runs[4], 4),
               round_robin4_first4=agree(rr, 4))
    if (loss >= 4.0 or out["chai6"] <= 0.7
            or out["chai4"] < out["round_robin4"] - 0.05
            or not l_mha["paged_decode"] or l_mha["paged_chai_fused_decode"]
            or not all(launches[f"tiny_trained_chai_k{k}"][
                "paged_chai_fused_decode"] for k in (6, 4))):
        raise AssertionError(f"phase 23c tiny: {out}, launches {launches}")
    log(f"phase 23c ({smi}): the tiny model ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads, fp32) trained on the card "
        f"for 60 steps, loss {loss:.4f}; the offline elbow on 8 "
        f"calibration sequences of 32 tokens: cluster counts "
        f"{elbow['counts']}, mean |offdiag| "
        f"{[round(x, 4) for x in elbow['offdiag']]}; greedy agreement with "
        f"MHA over "
        f"{TINY_PROMPTS} prompts x 16 tokens (the first 4 prompts): CHAI "
        f"k 6 {out['chai6']:.4f} ({out['chai6_first4']:.4f}), CHAI k 4 "
        f"{out['chai4']:.4f} ({out['chai4_first4']:.4f}), round-robin k "
        f"4 {out['round_robin4']:.4f} ({out['round_robin4_first4']:.4f}); "
        f"launches {launches}; {time.time() - t0:.1f} s")
    return launches, out


def training_paths():
    """Phase 23: the training stack (23a ``train_step_path``, 23b ``resume_path``, 23c
    ``train_serve_path`` and ``trained_tiny_path``), its checkpoints under
    a temporary directory removed at the end. Returns ({path: launches},
    summary)."""
    _free()
    t0 = time.time()
    smi = smi_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt.")
    try:
        log(f"phase 23: free disk under {root}: "
            f"{shutil.disk_usage(root).free / 1e9:.1f} GB; device memory "
            f"allocated at the start {torch.cuda.memory_allocated():,} B")
        launches, sums = train_step_path(smi)
        cfg, params, ckpt_dir, sums["resume"] = resume_path(smi, root)
        launches.update(train_serve_path(smi, cfg, params, ckpt_dir))
        del params
        _free()
        got, sums["tiny"] = trained_tiny_path(smi, root)
        launches.update(got)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 23: {time.time() - t0:.1f} s")
    return launches, sums


def main():
    environment()
    build_kernels()
    count_eager_decode()
    dense_cases = kernel_checks()
    paged_cases = paged_kernel_checks()
    emit_cases = emit_state_checks()
    relay_cases = relay_kernel_checks()
    split_cases, long_relay = split_decode_checks()
    flash_cases, prefix_cases = prefill_kernel_checks()
    pipe_cases = pipeline_kernel_checks()
    decode_cases = flash_decode_checks()
    int8_cases = int8_kernel_checks()
    kv_cases = kv_pairing_checks()
    share_cases = share_kernel_checks()
    softcap_cases = softcap_kernel_checks()
    mode_cases = prefill_mode_checks()
    g_layer = gemma2_suffix_prefill_check()
    wide_cases, narrow_cases = wide_head_checks()
    for arch in (ARCH, NEMO):
        reduced_reference_check(arch)
        reduced_continuous_check(arch)
        reduced_mha_check(arch)
        reduced_prefix_relay_check(arch)
    reduced_chunked_check()
    reduced_arch_checks()
    # Phase 23: the training stack, no kernel on its path; the trained
    # weights served through the kernels. It runs here, on a card that
    # holds nothing else: from phase 20 on, 13.5 GB of chai-llama-7b's
    # weights stay allocated to the end of the script.
    train_launches, _ = training_paths()
    cfg, params = init_full_model()
    cohort_launches, dense_main, cohort_cap, cohort_mha = main_path(cfg,
                                                                    params)
    (cont_launches, paged_main, paged_mixed, mono, cont_cap,
     cont_summary) = continuous_path(cfg, params)
    mha_launches, mha_mains = mha_baseline_path(cfg, params, cont_summary,
                                                "mha_continuous")
    chunked_launches, prefill_mains, path_cases = chunked_path(cfg, params,
                                                               mono)
    prefix_launches, relay_main, emit_main, prefix_main = prefix_path(
        cfg, params)
    # Phase 11, chai-llama-7b: the int8 KV cache on phases 6 and 8's traffic.
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    side_summary = side_konly(*cut_depth(cfg, params))
    i8_launches, i8_mains, i8_summary = int8_path(
        *cut_depth(cfg8, params), side_summary, "int8_continuous")
    i8_mha_launches = int8_mha_path(*cut_depth(cfg8, params),
                                    "int8_mha_continuous")
    i8_prefix_launches, i8_relay, i8_emit, i8_prefix = prefix_path(
        *cut_depth(cfg8, params), tag="int8_prefix")
    # Phase 12: share_values (CHAI-QKV), bf16 and int8.
    share_launches, share_mains, share8_cap = share_path(
        cfg, params, side_summary, i8_summary)
    # Phase 15, chai-llama-7b: the front door; phase 16: the offline phase
    # and the policies.
    front_launches, _ = front_door_path(cfg, params)
    offline_path(cfg, params)
    policy_path(cfg, params)
    # Phase 17, chai-llama-7b: the failure model.
    fault_launches = soak_path(cfg, params)
    fault_launches.update(degraded_path(cfg, params, mono))
    audit_launches, audit_copies = audit_cost_path(cfg, params)
    fault_launches.update(audit_launches)
    fault_launches.update(front_door_faults(cfg, params))
    # Phase 18, chai-llama-7b: telemetry; phase 19: the KV tiers.
    tel_launches, _ = telemetry_path(cfg, params, audit_copies["basic"])
    tier_launches, _ = kv_tiers_path(cfg, params)
    # Phase 20, chai-llama-7b: priority preemption, the async front door
    # and the HTTP server.
    preempt_launches, _ = preemption_path(cfg, params)
    async_launches, _ = async_path(cfg, params)
    # The engines of phases 5-8 sit in reference cycles (their wrapped
    # hooks); collect them so chai-llama-7b's weights are really freed.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ncfg, nparams = init_full_model(NEMO)
    (nemo_launches, nemo_cases, nemo_dc, nemo_pc,
     _) = nemotron_path(ncfg, nparams)
    # nemotron's side paths on its first SIDE_DEPTH layers: the K-only
    # pair they are held against, the MHA baseline, the prefix traffic
    # with relay off and on (phase 9), the int8 pair (phase 11).
    t0 = time.time()
    nemo_side = side_konly(*cut_depth(ncfg, nparams))
    nemo_mha_launches, nemo_mha = mha_baseline_path(
        *cut_depth(ncfg, nparams), nemo_side, "nemotron_mha")
    nemo_prefix_launches, nemo_relay, nemo_emit, nemo_prefix = prefix_path(
        *cut_depth(ncfg, nparams), tag="nemotron_prefix")
    n8_launches, n8_mains, _ = int8_path(
        *cut_depth(ncfg.replace(kv_cache_dtype="int8"), nparams), nemo_side,
        "int8_nemotron")
    log(f"nemotron's side paths on {SIDE_DEPTH} layers (K-only pair, MHA "
        f"baseline, prefix and relay, int8 pair): {time.time() - t0:.1f} s")
    # Phase 15, nemotron-4-15b: the seeded front door.
    nemo_front_launches = front_door_gqa(ncfg, nparams)
    del nparams
    gc.collect()
    torch.cuda.empty_cache()
    _, r_max = clustering.chai_widths(ncfg)
    ref_in = reference_lane_input()
    lane_runs = len(MODE_RUNS)        # the lanes' runs: not serving paths
    lane_launches, _ = pipeline_lane([
        ("reference_lane_shape", "dense", ref_in, 1, False),
        ("reference_lane_shape_int8", "dense", ref_in, 1, True),
        ("cohort_first_steady_layer0", "dense", cohort_cap, 1, False),
        ("cohort_first_steady_layer0_int8", "dense", cohort_cap, 1, True),
        ("continuous_paged_first_steady_layer0", "paged", cont_cap, 1,
         False),
        ("nemotron_dense_first_steady_layer0", "dense", nemo_dc, r_max,
         False),
        ("nemotron_paged_first_steady_layer0", "paged", nemo_pc, r_max,
         False)])
    # The share_values int8 lane on its own run: the pipeline's AV reads
    # raw int8 codes (``chai_av[int8]``), the fused kernel's share + int8
    # mode beside it.
    lane8_launches, _ = pipeline_lane([
        ("share_int8_dense_first_steady_layer0", "dense", share8_cap, 1,
         True)])
    lane_runs = range(lane_runs, len(MODE_RUNS))
    av8_mains = share_int8_av_cases(share8_cap)
    # The six pipeline kernels at the continuous main path's shapes (its
    # first all-STEADY step, layer 0) and at nemotron's.
    k, v = densified(cont_cap)
    pipe_mains = pipeline_stage_cases(
        "continuous_paged_first_steady_layer0", cont_cap["q"], k, v,
        cont_cap["h2c"], cont_cap["pos"], rpg=1, mask_row=False,
        profile=True, pages=(cont_cap["k_pool"], cont_cap["bt_k"],
                             cont_cap["v_pool"], cont_cap["bt_v"]))
    k, v = densified(nemo_pc)
    qpk = ncfg.q_per_kv
    nemo_stage = pipeline_stage_cases(
        "nemotron_paged_first_steady_layer0", nemo_pc["q"], k,
        v.repeat_interleave(qpk, 1), nemo_pc["h2c"], nemo_pc["pos"],
        rpg=r_max, mask_row=False, profile=True,
        pages=(nemo_pc["k_pool"], nemo_pc["bt_k"],
               nemo_pc["v_pool"].repeat_interleave(qpk, 1), nemo_pc["bt_v"]))
    # Phases 13 and 14: local-attention rings and the softcap, on
    # gemma2-9b's first SIDE_DEPTH layers (4 local, 4 global), its weights
    # made at that depth, then h2o-danube-1.8b's.
    t0 = time.time()
    gcfg, gparams = init_full_model(GEMMA, n_layers=SIDE_DEPTH)
    g_launches, g_cases, g_sums = gemma2_path(gcfg, gparams)
    sp_launches, _ = gemma2_suffix_prefill_path(gcfg, gparams,
                                                "gemma2_suffix_prefill")
    # Phase 14: gemma2-9b on the int8 KV cache, on phase 13's weights.
    gcfg8 = gcfg.replace(kv_cache_dtype="int8")
    g8_launches, g8_cases, _ = gemma2_int8_path(gcfg8, gparams, g_launches,
                                                g_sums)
    sp8_launches, _ = gemma2_suffix_prefill_path(
        gcfg8, gparams, "gemma2_int8_suffix_prefill")
    log(f"phases 13-14 (gemma2-9b, {gcfg.n_layers} layers): "
        f"{time.time() - t0:.1f} s")
    del gparams
    gc.collect()
    torch.cuda.empty_cache()
    dcfg, dparams = init_full_model(DANUBE, n_layers=SIDE_DEPTH)
    d_launches, d_sums = danube_path(dcfg, dparams)
    d8_launches = danube_int8_path(dcfg, dparams, d_sums["cohort"])
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 21: the attention archs of ROADMAP #14 part B.
    g3_launches, g3_cases, _ = gemma3_path()
    moe_launches, _ = moe_paths()
    # Phase 22: the recurrent archs (RG-LRU, RWKV), no kernel on any path.
    rec_launches, _ = recurrent_paths()
    by_path = {"cohort": cohort_launches, "mha_cohort": cohort_mha,
               **cont_launches, **mha_launches,
               "continuous_paged_chunked": chunked_launches,
               **prefix_launches, **nemo_launches, **nemo_mha_launches,
               **nemo_prefix_launches, **i8_launches, **i8_mha_launches,
               **i8_prefix_launches, **n8_launches, **share_launches,
               **g_launches, **d_launches, **sp_launches, **g8_launches,
               **sp8_launches, **d8_launches, **front_launches,
               **nemo_front_launches, **fault_launches, **tel_launches,
               **tier_launches, **preempt_launches, **async_launches,
               **g3_launches, **moe_launches, **rec_launches,
               **train_launches,
               "pipeline_lane": lane_launches,
               "pipeline_lane_share_int8": lane8_launches}
    mains = {"chai_fused_decode": (
                 dense_main, "cohort",
                 dense_cases + emit_cases["chai_fused_decode"]
                 + split_cases["chai_fused_decode"]
                 + [dense_main] + nemo_cases["chai_fused_decode"]),
             "paged_chai_fused_decode": (
                 paged_main, "continuous_paged",
                 paged_cases + emit_cases["paged_chai_fused_decode"]
                 + split_cases["paged_chai_fused_decode"]
                 + [paged_mixed, emit_main, paged_main]
                 + nemo_cases["paged_chai_fused_decode"] + [nemo_emit]),
             "relay_prefix_decode": (relay_main, "prefix_relay",
                                     relay_cases + long_relay
                                     + [relay_main, nemo_relay]),
             "flash_decode": (mha_mains["flash_decode"],
                              "mha_continuous_dense",
                              decode_cases["flash_decode"]
                              + [mha_mains["flash_decode"],
                                 nemo_mha["flash_decode"]]),
             "paged_decode": (mha_mains["paged_decode"],
                              "mha_continuous_paged",
                              decode_cases["paged_decode"]
                              + [mha_mains["paged_decode"],
                                 nemo_mha["paged_decode"]]),
             "flash_prefill": (prefill_mains["flash_prefill"],
                               "continuous_paged_chunked",
                               flash_cases + path_cases["flash_prefill"]),
             "paged_prefix_attend": (
                 prefill_mains["paged_prefix_attend"],
                 "continuous_paged_chunked",
                 prefix_cases + path_cases["paged_prefix_attend"]
                 + [prefix_main, nemo_prefix])}
    # The hd-128 rows of the fused and flash decode pairs, timed beside the
    # wide head in phase 3.
    for name, cases in narrow_cases.items():
        mains[name][2].extend(cases)
    # The wide head (head_dim 320): one row each, on gemma3-4b's paths
    # (phase 21a).
    for name, path in (("chai_fused_decode", "gemma3_continuous_dense"),
                       ("paged_chai_fused_decode", "gemma3_continuous_paged"),
                       ("flash_decode", "gemma3_mha_dense"),
                       ("paged_decode", "gemma3_mha_paged")):
        mains[f"{name}[wide]"] = (g3_cases[name], path,
                                  wide_cases[f"{name}[wide]"]
                                  + [g3_cases[name]])
    for name in PIPE_KERNELS:
        mains[name] = (pipe_mains[name][0], "pipeline_lane",
                       pipe_cases[name] + pipe_mains[name]
                       + nemo_stage[name])
    # The AV pair's int8 V: chai_av on the share_values int8 lane; the
    # paged pipeline has no int8 K stage, so no path reaches paged_chai_av
    # on int8 codes (its launches by mode over every run must be 0).
    mains["chai_av[int8]"] = (av8_mains["chai_av"],
                              "pipeline_lane_share_int8",
                              pipe_cases["chai_av[int8]"]
                              + [av8_mains["chai_av"]])
    mains["paged_chai_av[int8]"] = (av8_mains["paged_chai_av"], None,
                                    pipe_cases["paged_chai_av[int8]"]
                                    + [av8_mains["paged_chai_av"]])
    # The QK pair's raw int8 K: no path of the reference reaches it (its
    # int8 pipeline runs chai_qk_i8 with scales), so its launches by mode
    # over every run must be 0; the main case is the continuous capture's.
    for name in QK_ROWS:
        mains[name] = (pipe_mains[name][0], None,
                       pipe_cases[name] + pipe_mains[name] + nemo_stage[name])
    # The int8 modes: one row each, on its int8 serving path (phase 11).
    int8_mains = {
        "chai_fused_decode": (
            i8_mains["chai_fused_decode"], "int8_continuous_dense",
            int8_cases["chai_fused_decode"] + [
                i8_mains["chai_fused_decode"],
                n8_mains["chai_fused_decode"]]),
        "paged_chai_fused_decode": (
            i8_mains["paged_chai_fused_decode"], "int8_continuous_paged",
            int8_cases["paged_chai_fused_decode"] + [
                i8_mains["paged_chai_fused_decode"], i8_emit,
                n8_mains["paged_chai_fused_decode"]]),
        "relay_prefix_decode": (i8_relay, "int8_prefix_relay",
                                int8_cases["relay_prefix_decode"]
                                + [i8_relay]),
        "paged_prefix_attend": (i8_prefix, "int8_prefix_plain",
                                int8_cases["paged_prefix_attend"]
                                + [i8_prefix])}
    for name, main_info in int8_mains.items():
        mains[f"{name}[int8]"] = main_info
    # The share_values modes: one row each, on its share path (phase 12).
    for name, (main_case, path, cases) in share_mains.items():
        mains[f"{name}[share]"] = (main_case, path,
                                   share_cases[name] + cases)
    # The softcap modes: one row each, on its gemma2 path (phase 13).
    for name, path in (("chai_fused_decode", "gemma2_continuous_dense"),
                       ("paged_chai_fused_decode",
                        "gemma2_continuous_paged")):
        mains[f"{name}[softcap]"] = (g_cases[name], path,
                                     softcap_cases[name] + [g_cases[name]])
    # Phase 14: the int8 x softcap mode of the fused pair on gemma2 int8.
    for name, path in (("chai_fused_decode", "gemma2_int8_continuous_dense"),
                       ("paged_chai_fused_decode",
                        "gemma2_int8_continuous_paged")):
        mains[f"{name}[int8+softcap]"] = (
            g8_cases[name], path,
            [c for c in softcap_cases[name] if "int8" in c["case"]]
            + [g8_cases[name]])
    # The modes of the prefill pair and the relay: the softcap on gemma2's
    # model-level suffix prefill (phases 13 and 14; the main cases are
    # gemma2's full-width layer check of phase 3); the window of
    # flash_prefill and the softcap of the relay on no path (the
    # reference reaches neither): their launches are counted by mode over
    # every run of the process, and must be 0.
    mains.update({
        "flash_prefill[softcap]": (
            g_layer["flash_prefill"], "gemma2_suffix_prefill",
            mode_cases["flash_prefill[softcap]"] + [g_layer["flash_prefill"]]),
        "flash_prefill[window]": (mode_cases["flash_prefill[window]"][0],
                                  None, mode_cases["flash_prefill[window]"]),
        "paged_prefix_attend[softcap]": (
            g_layer["paged_prefix_attend"], "gemma2_suffix_prefill",
            mode_cases["paged_prefix_attend[softcap]"]
            + [g_layer["paged_prefix_attend"]]),
        "paged_prefix_attend[int8+softcap]": (
            g_layer["paged_prefix_attend_int8"],
            "gemma2_int8_suffix_prefill",
            mode_cases["paged_prefix_attend[int8+softcap]"]
            + [g_layer["paged_prefix_attend_int8"]]),
        "relay_prefix_decode[softcap]": (
            mode_cases["relay_prefix_decode[softcap]"][0], None,
            mode_cases["relay_prefix_decode[softcap]"])})
    # The K/V pairings no serving path runs: one row each, launches by mode
    # over every run; int8 K with scales beside float V is phase 10's int8
    # lanes' fused side (fp32 V on the reference's lane shape, bf16 on the
    # cohort capture), one launch each.
    for name, cases in kv_cases.items():
        if "[kv=" not in name:    # the int8 body's: cases join its row
            mains[name][2].extend(cases)
            continue
        lane = name in ("chai_fused_decode[kv=i8s/f32]",
                        "chai_fused_decode[kv=i8s/bf16]")
        mains[name] = (cases[0], "pipeline_lane" if lane else None, cases)
    serving = [run for i, run in enumerate(MODE_RUNS) if i not in lane_runs]
    kv_served = {key: n for run in serving for key, n in run.items()
                 if "kv=" in key and n}
    if kv_served:
        raise AssertionError(f"K/V pairings launched on serving paths: "
                             f"{kv_served}")
    kernel_rows = {name: KERNEL_ROWS[name.split("[")[0]] for name in mains}
    rows = []
    for name, info in kernel_rows.items():
        main_case, path, cases = mains[name]
        base = name.split("[")[0]
        # A finalized bf16 output is held at one bf16 step; its error
        # stands in its own case.
        held = [c for c in cases if c.get("tolerance", "2e-5") == "2e-5"]
        rows.append(dict(
            name=name, **info, path=path,
            # a mode no serving path reaches: its launches by mode over
            # every run, held at 0 below (a K/V pairing's: by mode, 0 on
            # every serving path, held above)
            launches=(mode_launches(name) if "[kv=" in name
                      else by_path[path][base] if path
                      else mode_launches(name)),
            launches_by_path={p: c[base] for p, c in by_path.items()},
            **({"mode_launches_all_runs": mode_launches(name)}
               if "[" in name and name not in MODE_BLIND else {}),
            max_abs_err=max(c["max_abs_err"] for c in held),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case.get("library_ms"),
            library_device_ms=main_case.get("library_device_ms"),
            single_call_ms=main_case["single_call_ms"],
            device_ms=main_case["device_ms"], cases=cases))
        if path is not None and not rows[-1]["launches"]:
            raise AssertionError(f"{name}: no launch on its path {path}")
        if path is None and rows[-1]["launches"]:
            raise AssertionError(f"{name}: {rows[-1]['launches']} launches "
                                 "in the runs of this process, though no "
                                 "path of the reference reaches the mode")
    for row in rows:
        if (row["name"] in REWRITTEN + QK_KERNELS + AV_ROWS[:2]
                or "[" in row["name"]):
            log(f"{row['name']} (main path {row['launches']} launches): "
                f"device {row['device_ms']} ms, back to back "
                f"{row['ms']:.4f} ms, single call "
                f"{row['single_call_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
                f"device {row['library_device_ms']} ms")
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
