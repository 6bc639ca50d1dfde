#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Build: compile the eight kernels (three gossip mixes, the SIMT and
   the tensor-core flash attention, the MoE router alone and fused with
   the grouped dispatch's slots, the tensor-core SSD intra-chunk term)
   from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print ptxas's register and
   spill report and warnings; a spill in ``ssd_chunk_tc``, in either
   router kernel (``moe_router``, ``moe_route_slots``), in any
   instantiation of the SIMT flash kernel (f32 and bf16 at head dims 32,
   64, 96, 112 and 128, each taking the widths up to it, and its merge
   pass) or in the dense gossip mix's tile regime fails.
2. Kernels: hold each kernel against its plain PyTorch version on the card.
   Gossip mixes at the main path's leaf shapes (W = 22), at the MLP's
   leaves in the Table 3 (W = 60), storm (W = 23) and cross-device cohort
   (k = 64: the dense mix's tile regime) worlds, with identity rows in P
   at k = 64 (bit-equal on a bf16 payload), at a ragged F, at
   W in {48, 49, 64, 65, 128, 129, 200} (both sides of the dense mix's
   regime boundary at 48), at W=500 / density 0.05 / F in {4096, 4099}, at
   W = 1,000 / K = 100 (the sparse mix's slot groups), for every
   payload type, and the sparse and int8 mixes at W = 12,000 (their gather
   branches), each call checked to launch once in the regime or branch it
   should (``ops.REGIMES``); a zero-weight slot of the sparse mix that
   names a row holding inf, whose NaN and inf masks must equal the plain
   version's, in both branches; flash attention at
   S in {17, 64, 200, 256, 512, 1000, 4096}, D in {64, 128}, causal,
   window 128 and non-causal, f32 (the SIMT kernel, one-ulp limit) and
   bf16 (the tensor-core kernel, ``ref.flash_tc_limit``), bf16 at D = 32
   (SIMT), four adversarial cases (``ref.flash_adversarial``), and the
   main path's two prefill shapes and Jamba's [1, 32, 4096, 128] in its
   layout (bf16 views of [B, S, H, D] tensors), whisper's cross-attention
   with k and v of their own length (Sq in {1, 17, 448} over Sk in {64,
   1500}, D = 64) and its encoder's non-causal S = 1500, f32 (SIMT) and
   bf16 (tensor cores), the SIMT kernel at the reduced whisper's
   D = 42 (columns past D masked in the kernel), and the four flash calls
   of the phase [8] prefills at their shapes, B = 4 and layout
   (``ENCDEC_FLASH``); the SIMT kernel (``mma.sync`` on the tensor cores,
   its key range split over CTAs where the grid is small) at Kimi-K2's
   full-width call [1, 64, 4096, 112] bf16 in the model's layout (k and v
   repeated from 8 kv heads), at bf16 D in {80, 96} (ragged, split,
   across lengths) and on the adversarial cases in f32 and in bf16 at
   D = 96; each call checked to launch the kernel its dtype and D select;
   the router at T in {4, 1000, 2048, 4096, 32768}, (E, k) in {(64, 6),
   (16, 2)}, and at T in {4, 4096}, (E, k) in {(128, 8), (512, 32)}, with
   rows of exact ties;
   both in f32 and bf16; the fused route-and-slot kernel on the first
   cases plus T = 32768 (1024 tiles) and routers skewed to overflow the
   capacity: gates and indices as the router's, slots and the inverse
   map exact against the plain rank of the kernel's own indices, equal
   across two calls and in a CUDA graph replay, and one grouped MoE layer
   captured in a CUDA graph (no host synchronisation). ssd_chunk in the
   main path's layout (x a view of the model's [G, T, H, P] chunks) with
   the model's decays (A_log = log(1..H), dt = softplus): Mamba2-780M's
   [G, H, T, N, P] = [32, 48, 256, 128, 64] and [64, 48, 256, 128, 64],
   a ragged T = 200, the Jamba shape
   (N = 16, H = 128), a reduced shape (N = 16, P = 32, T = 32), H = 12
   at P = 16, Mamba2-780M's inner width in heads of 16 ([32, 192, 256,
   128, 16]; no model runs P = 16), and the main shape with x contiguous,
   each through ``ops.ssd_chunk`` (one ``ssd_chunk_tc`` launch); limit
   1e-5 * max|y| of each call. The tensor-parallel
   shards' full-width shapes ([10], [11]): flash on a model shard's query
   heads, [B, H / tp, S, 128] (``TP_FLASH``: [2, 4, 4096], [8, 4, 4096],
   [1, 4, 32768] (the plain version 4,096 queries at a time) and [2, 4,
   512] in bf16, [2, 4, 128] in f32), and ``ssd_chunk`` on its 12 heads
   at Mamba2-780M's S = 32,768 and the reduced model's 4 and 8.
3. Timings: device time per call (CUDA graphs of back-to-back calls, timed
   with CUDA events) of the kernel, its plain version and, where one
   exists, one PyTorch library call computing the same function, at the
   main paths' shapes (the gossip mixes at W = 22, 60, 64 and 500, with the
   dense mix's bound both on the CUDA cores and in 3xTF32 on the tensor
   cores and ``torch.matmul`` beside it, the sparse mix also on a bf16
   payload; flash and ssd_chunk in the main
   path's layout;
   flash as the tensor-core kernel, the SIMT kernel through its C entry
   at the same bf16 shapes, the plain version and SDPA; ssd_chunk_tc and
   the plain version at Mamba2-780M's two prefill shapes, Jamba's [16,
   128, 256, 16, 64] and the two P = 16 shapes of [2]; the router at T
   in {2048, 4096, 4, 32768} beside the floor of the timing (a
   one-element ``add_``); the fused route-and-slot kernel, its plain
   version and the route it replaced, the router and a one-hot ``cumsum``
   rank, at T in
   {2048, 4096, 4, 32768}, E = 64, k = 6 and T = 4096, E = 16, k = 2);
   flash as
   the tensor-core kernel, the SIMT kernel, the plain version and SDPA at
   the phase [8] prefills' shapes (``ENCDEC_FLASH``: whisper's encoder
   [4, 6, 1500, 64], cross-attention 448 over 1,500 and causal decoder
   [4, 6, 448, 64]; InternVL2-2B's [4, 16, 768, 128]), with each shape's
   bytes/flops bound; the SIMT kernel beside its plain version and SDPA
   in the same dtype at the calls that reach it (``SIMT_TIMED``: the f32
   qwen3 TP shard [2, 4, 128, 128], the example's [4, 12, 128, 64], the
   harness's [1, 4, 512, 64], whisper's f32 encoder and 448-over-1,500
   cross-attention, Kimi-K2's bf16 [1, 64, 4096, 112] and the C entry's
   bf16 [64, 512, 128]), with the bound at the fp32 CUDA-core rate and,
   for f32, at the 3xTF32 rate.
4. DeFTA, FedAvg and AsyncDeFTA end to end, all in the Table 2 world (20
   workers + 2 noise attackers, MLP, ``local_epochs=5``). The port's
   ``run_defta`` (20 epochs) on the fp32 wire with ``auto`` (sparse
   kernel), the int8 + EF21 wire (quant kernel) and ``backend="pallas"``
   (dense kernel), and the CNN world on ``auto``; every run's launch counts
   must equal leaves x epochs (0 for the serving kernels). ``run_fedavg``
   as CFL-F, CFL-S and FedAdam (20 epochs each): no kernel launch and a
   finite server loss; CFL-F's accuracy > 0.3 in the world without the
   attackers, which drag the undefended server down (paper Table 3).
   ``run_async_defta`` for 20
   ticks on the same three wires, and once with a target (``check_every=4``)
   that stops it early: each must launch its wire's kernel exactly leaves
   x ticks run times and nothing else, and its workers' epochs must spread.
   Small worlds (DeFTA, FedAdam with an attacker on CFL-S, async on each of
   the three kernels) also run on the card and on the CPU (plain versions)
   from the same initial state and draws, and the two must agree, with
   equal epoch counters.
4s. Scenarios end to end. The paper's Table 3 world (20 vanilla workers +
   40 noise attackers, W = 60, DTS and the time machine) as the scenario
   ``paper_noise@40`` and as ``num_malicious=40`` on ``auto``, 20 epochs:
   4 leaves x 20 = 80 ``gossip_mix_sparse`` launches in its slice branch
   each, vanilla accuracy > 0.3; the same world on ``pallas``: the dense
   mix's tile regime only. ``storm`` (W = 23) on the fp32 wire (sparse
   mix), the int8 + EF21 wire with stochastic rounding (quant mix) and
   ``pallas`` (dense mix, stream regime): leaves x epochs launches each.
   Time-varying topologies at W = 60 (re-drawn every 5 and every 2
   epochs): each support union's density and the kernel ``auto`` picks
   for it. trimmed_mean, median and krum at W = 60
   with noise@40: no mix launch. AsyncDeFTA under ``storm`` with a target
   (an early exit). Card vs CPU: a reduced ``storm`` on each kernel and a
   ``krum`` world, from one initial state and draw stream: states within
   the phase-4 limits, equal epoch counters, Krum's picks equal round by
   round.
4t. DTS v2 and v3 trust channels end to end (update geometry, the
   sign-sketch ring buffer, cross-round correlation). The trust grid's
   world (``benchmarks/table_trust.py``: 20 vanilla workers + 8 attackers,
   W = 28, non-iid α = 0.5, 3 local epochs): ``alie`` and ``label_flip``
   × ``dts_signal`` ∈ loss, geom, both, corr, all on ``auto`` (sparse
   mix, slice branch), 10 epochs each: leaves x epochs launches, a finite
   ``conf`` and, under corr / all, every fired worker's ring buffer
   filled. The Table 3 world at full width (20 vanilla + 40 ``alie``
   colluders, W = 60) under ``loss`` and ``all`` on ``auto`` (sparse),
   and under ``all`` on ``pallas`` (the dense mix's tile regime only), 10
   epochs each. AsyncDeFTA under
   ``storm`` with ``all``, 20 ticks, a ring buffer deeper than the run:
   each worker's filled slots equal its epoch (rows of ticks it did not
   fire stay put). Card vs CPU: ``port_robustness_demo``'s world (12
   vanilla + 4 alie colluders, a straggler, ``all``), 6 epochs from one
   initial state and draw stream: equal epochs, ``conf`` and losses within
   1e-4, sketches equal outside buckets whose projection is within 1e-5
   of its row's norm of 0. The trust functions at W = 60, D = 2,762 make
   no host synchronisation (``torch.cuda.set_sync_debug_mode``).
4c. Cross-device participation end to end. The reference launcher's
   ``--cross-device`` default at full width (10,000 enrolled users, a
   cohort of k = 64 a round, availability 0.7, dropout 0.05, straggle
   0.10, 48 examples each, MLP, 3 local epochs, ``dts_conf_decay`` 0.98,
   ``label_flip`` 0.15 + ``alie`` 0.14), 30 rounds under ``loss`` and
   ``all`` on fp32 and under ``all`` on int8 + EF21: exactly 4 dense-mix
   launches a round, all in the tile regime, and no other gossip launch;
   a finite ``conf``; the rows of users who never fired unchanged; every
   fired user's stamps its fired rounds in order; the honest probe
   accuracy above the untrained model's; ms a round and peak memory. The
   benchmark's attacked world (28 enrolled, k = 14) under ``all``: 4
   launches a round in the stream regime. Card vs CPU: the full-width
   world under ``all``, 6 rounds from one population and draw stream:
   ``conf``, params and losses within 1e-4, counters and stamps equal,
   sketches equal outside near-zero buckets.
4p. The privacy wire end to end (pairwise secure aggregation in the wire's
   integer ring, DP-SGD, update DP, ``masked_geom`` trust). At the MLP's
   leaves in the Table 3 world (W = 60) and the cohort (k = 64, all-ones
   support): the masked mix equals the unmasked K-slot gather-sum bit for
   bit on fp32, bf16 and int8 + EF21 (residuals equal, int8 round-trip
   error equal), launches no gossip kernel, its fp32 wire words differ
   from the plaintext, and the card's pads equal the CPU's bit for bit;
   one pad block's words, launches and device ms. The Table 2 world on
   each wire plain and under secagg (no gossip launch; the secagg run's ms
   beside the plain run's), DP-SGD and update DP (leaves x epochs sparse
   launches; ``dp_noise`` built for update DP only); the Table 3 world
   with 40 alie colluders under ``all`` with secagg ``edge`` and
   ``masked_geom``, each with update DP (the ring rotates under ``edge``
   only); async ``storm`` with secagg and update DP; the [4c] world at
   full width under ``all`` plain, with secagg + update DP and with
   ``masked_geom`` + update DP (no gossip launch; sketches and stamps
   unchanged under ``masked_geom``): ms, launches by regime and peak
   memory of each. Card vs CPU: the Table 2 int8 + EF21 secagg world
   (phase 4's int8 limits, models within one quantization step) and the
   full-width cross-device secagg world, 6 rounds (within 1e-4, counters
   and stamps equal).
4m. The telemetry plane and the launcher. Each gossip mix the launcher's
   worlds run, against its plain version at their shapes (the dense mix
   at W = 10, stream; the sparse and int8 mixes on ``paper_noise@40``'s
   W = 60 topology; the dense mix at k = 64, tile). One chunk of the
   Table 2 world under ``torch.cuda.set_sync_debug_mode("warn")``: no
   more synchronisation warnings with probes than without. The Table 2
   world (20 epochs), the Table 3 world (``paper_noise@40``, W = 60), the
   [4c] full-width world under ``all`` (30 rounds) and async ``storm``
   (20 ticks, a target), each with probes off, on, on, off (a ledger
   each; ``probes=False`` builds the round without a registry): the
   states equal bit for bit, the gossip launches equal, one row a round
   per probe, ms a unit off and on side by side. Then
   ``python -m repro_torch.launch.train`` in a subprocess for the CI's
   smokes (scenario, cross-device, secagg, secagg cross-device,
   telemetry), the README's Table 3 (``paper_noise@40``, 50 epochs) and
   async ``storm`` (median) commands and the Table 3 world on the int8
   wire, each with ``--telemetry`` (one also with ``--profile``): exit 0
   (``--assert-acc`` met), the gossip launches by regime it must make,
   a ledger of manifest, one row per epoch or tick run and summary, and
   ``benchmarks/render_experiments.py --telemetry-panel`` rendering it;
   the profiled run leaves a Chrome trace with the stages' ranges.
4w. Worker-axis sharding, every shard on the card (``shard_devices=
   ["cuda:0"] * S``). The sparse (f32, bf16) and int8 mixes against their
   plain versions at the local blocks the sharded transport hands them
   (W_local = 4, 15, 13 and 1,250: W = 16, 60 and 100 on 4, 4 and 8
   shards, 10,000 on 8), first and last shard, the MLP's leaves; timed
   at W_local = 15 and 1,250. Sharded against unsharded on the card, one
   seed and one draw stream: the Table 2 world on 2 and 4 shards (4
   epochs), its int8 + EF21 wire on 4 (one quantization step), secagg
   on the fp32 and int8 wires on 4 (equal to plain sharded bit for bit),
   the Table 3 world with 40 alie colluders under ``all`` on 4 (one
   round), W = 100 on 8 (warned, state whole, transport padded), async
   ``storm`` on 4 (4 ticks) and the launcher's cross-device world
   (10,000 enrolled, k = 64) on 4: every field within rtol and atol
   1e-4, epochs, ticks, stamps, counters and sketches equal; the local
   kernels launch shards x leaves x rounds, the k-block its 4 tile
   launches a round; the bytes moved between shards equal
   ``roofline.sharded_ring_bytes``. W = 10,000 on 8 shards for 2 epochs
   (every epoch 2; state a shard and the card's peak memory). ms an
   epoch at 1, 2 and 4 shards on the Table 2 world, in turns.
4f. LM training and DeFTA across pods. The flash kernel under autograd
   (its forward; the gradient of the plain version, recomputed) at the
   pods' [2, 4, 128, 64] bf16 (tensor cores) and the example's [4, 12,
   128, 64] f32 (SIMT): the forward within [2]'s limits; dq, dk, dv equal
   to the plain version's within 1e-6 of their max (a plumbing check of
   the wrapper: the backward is the plain version's own, so no kernel's
   gradient is under test); kernel forward, recompute backward and plain
   forward + backward timed. The launcher's
   ``--fl`` (``launch.train.train_lm``) at paper-small's full width (2
   layers, d 256, vocab 33,278, bf16; seq 128, batch 8), 4 pods on the
   card, 8 steps, a gossip round every 4: in-process fp32, in-process
   int8 + EF21, the cross-pod ring fp32 and int8 + EF21, and ``--pod-dts
   --dts-signal all --pod-time-machine``; losses finite and falling,
   flash_attention_tc launches pods x layers x steps (+ pods x layers a
   round for the time machine's held-out evaluations) and no other
   kernel, ring bytes = rounds x ``roofline.ppermute_ring_bytes`` (the
   fp32 wire ships the bf16 leaves as they are: priced as "bf16"); ms a
   step, ms a gossip round, peak memory. On the trained pods' params (in
   f32): the ring = the in-process mix within 1e-5 (int8: one step), its
   bytes the contract; the three gossip mixes against their plain
   versions at every leaf's [4, F]; the pod round on ``pallas`` (dense),
   ``sparse`` and int8 on ``sparse`` (quant): one launch a leaf, params
   = the einsum round's. Ten steps of ``examples/port_train_federated.py``
   (~100M f32, 4 workers): 480 SIMT flash launches, finite losses.
5. Serving end to end: DeepSeekMoE-16B at full width and depth (28 layers,
   64 routed experts top-6 + 2 shared, bf16, random weights from a seed)
   initialised on the card; ``build_prefill_step`` at B=4, S=512 and at
   B=1, S=4096 (finite logits, wall ms), then the port's serve loop at its
   defaults (batch 4, prompt 32, 32 new tokens, greedy). Launch counts:
   28 tensor-core flash (0 SIMT flash) and 27 route-and-slot launches (0
   router) per prefill call, 27 router launches per decode step, none of
   the gossip kernels nor ssd_chunk. A reduced DeepSeekMoE (f32) is also
   served on the card and on the CPU from the same parameters (logits
   within 1e-4, equal greedy tokens), and its teacher-forced decode on the
   card must match its prefill within 2e-3; its card runs must launch the
   SIMT flash kernel and not the tensor-core one.
6. Mamba2-780M at full width and depth (48 layers, bf16, 780,148,992
   parameters, random weights from a seed) initialised on the card;
   prefill at B=4, S=2048 and B=1, S=16384 with exactly 48 ssd_chunk_tc
   launches per call and no other kernel; the serve
   loop at its defaults with no kernel launch (decode is the plain
   recurrence); peak memory. A reduced Mamba2 (f32) card vs CPU as in 5,
   at S = 40, which is not a multiple of its chunk of 32, so the pad path
   runs on the card; its card runs must launch ssd_chunk_tc.
7. Jamba at full width cut to one 8-layer period (13,267,656,416
   parameters, bf16): two prefill calls at B=1, S=4096 with 7
   ssd_chunk_tc, 1 tensor-core flash and 4 route-and-slot launches each
   (0 router) and finite logits.
8. Whisper-tiny (36,455,040 parameters) and InternVL2-2B (1,897,537,536)
   at full width and depth, bf16, random weights from a seed, each
   checked against its parameter count: whisper's prefill at B = 4 over
   1,500 frames with 448 decoder tokens, exactly 12 tensor-core flash
   launches a call (4 encoder, 4 causal decoder, 4 cross-attention) and 0
   SIMT flash; InternVL2-2B's at B = 4 with 256 vision and 512 text
   tokens, exactly 24; logits finite and of the text positions only; both
   serve loops at their defaults (batch 4, 32 + 32 tokens, greedy), with 4
   launches (whisper's single encode) and 0; wall ms, tok/s, peak memory;
   whisper's encode and 8 greedy decode steps make no host
   synchronisation (``torch.cuda.set_sync_debug_mode("error")``).
   Whisper in f32 at full width and at the reduced D = 42, card vs CPU as
   in 5: logits within 1e-4, equal greedy tokens, teacher-forced decode
   within 2e-3 of the prefill, through the SIMT kernel only.
9. Training the moe, ssm and hybrid families; expert parallelism. The
   three kernels' autograd Functions (kernel forward, the plain version's
   gradient recomputed; the routers' gates at the kernel's own picks):
   the route-and-slot kernel at DeepSeekMoE's train step (T = 1,024, E =
   64, k = 6, f32), the router at T = 4,096 and ``ssd_chunk_tc`` at
   Mamba2-780M's train step ([8, 48, 256, 128, 64]), each gradient equal
   to the plain version's within 1e-6 of its max; kernel forward,
   recomputed backward and plain forward + backward timed. Full-width
   ``build_train_step`` steps, bf16, random weights from a seed:
   DeepSeekMoE-16B cut to its dense first layer and three MoE layers (Adam,
   B = 2, S = 512, grouped dispatch; 7 tensor-core flash + 6
   route-and-slot launches a step), Mamba2-780M whole (Adam, B = 2, S =
   1,024; 96 ``ssd_chunk_tc``), Jamba's first five layers (mamba,
   mamba_moe, mamba, mamba_moe, attn_dense; SGD, B = 1, S = 1,024; 4 + 1
   + 2): losses and gradient norms finite, exact launches a step, ms a
   step, peak memory. Both full configs set ``remat``: each repeat of a
   scanned stack (DeepSeekMoE's three MoE layers, Mamba2's 48) runs under
   ``torch.utils.checkpoint`` and recomputes its forward in the backward,
   so its kernels launch twice a step; the Jamba slice's five layers
   repeat no pattern, are not scanned and launch once.
   Expert parallelism on a (4, 2) ("data", "model") mesh on
   ``["cuda:0"] * 8``, one full-width DeepSeekMoE MoE layer in bf16:
   ``eplocal`` at B = 4, S = 512 against ``grouped`` at ``cap_factor=8``
   (no pair drops) within ``EP_BF16_LIMIT``, ``eplocal_fp8``'s dispatch
   bytes beside bf16's, the replicated path at B = 1, S = 4,096 against
   ``dense``, each call's ms and device operations beside the one-device
   dispatch's; one train step of the cut DeepSeekMoE through ``eplocal``
   (24 route-and-slot launches, 12 of them the recompute's); the reduced
   f32 DeepSeekMoE's ``eplocal`` loss and gradient card vs CPU (``["cpu"]
   * 8``) within 1e-4.
10. Launch costing (``launch.dryrun``): four pairs of the dry run, each
   cut to fit the card (``COSTING_PAIRS``: qwen3-0.6b ``train_4k`` at B =
   2, S = 4,096 with Adam and remat; deepseek-moe-16b ``prefill_32k`` at
   B = 1, expert parallelism's replicated path, and at B = 8, S = 4,096,
   its all_to_all path; mamba2-780m ``prefill_32k`` at B = 1), on the
   production pod's ("data", "model") = (2, 4) mesh of the card repeated,
   the state placed by logical axis and the steps tensor-parallel, counted
   on meta and then run on the card under the same counter
   (``dryrun.measure``): the card's counted flops, bytes and kernel calls
   equal the meta count's, the launches of ``flash_attention_tc``,
   ``moe_router``, ``moe_route_slots`` and ``ssd_chunk_tc`` equal the
   counted calls, and the measured peak less what stood before the pair's
   state lies within 10 % or 256 MB of the meta peak; prints the step's ms
   and the roofline share.
11. Tensor parallelism inside a pod: reduced f32 qwen3-0.6b, granite-20b
   (one kv head), mamba2-780m, deepseek-moe-16b (eplocal) and whisper-tiny,
   each placed on (2, 2) and (2, 4) meshes of the card repeated against
   the same model unsharded on the card: logits and the loss within 1e-5,
   gradients within 1e-4 of their max, 8 greedy decode steps' logits within
   2e-3 with equal tokens; a forward launches the flash (or SSD) kernel
   layers x tp times. Full-width f32 qwen3-0.6b on (2, 4): a prefill (112
   SIMT flash launches against 28) with logits within 1e-5 and 8 greedy
   decode steps with tokens equal to unsharded, ms beside unsharded; one
   bf16 full-width train step (Adam, remat: 2 x 28 x 4 tensor-core flash
   launches) beside the unsharded one: the loss, the new parameters, Adam's
   moments and each leaf's update held to the unsharded step's
   (``TRAIN_STATE_LIMITS``, ``TRAIN_UPDATE_LIMIT``).
   [11c]: every flash and ssd_chunk shape that [10] and [11] launched
   (recorded by ``launched_shapes``) and [2] did not check is held against
   its plain version on fresh inputs in the model's layout, so that no
   shape a main path runs goes unchecked.
12. The benchmark harness (``benchmarks/port_kernel_bench.py``, the port
   of the reference's ``kernel_bench.py``) at cut epochs
   (``HARNESS_EPOCHS``): ``bench_gossip``'s nine cells (W in {20, 100,
   500} x density in {0.05, 0.3, 1.0}, F = 4096: the sparse and int8
   mixes at K up to 500, the dense mix in both regimes), each mix
   launching once and agreeing with the plain product within 1e-4 (the
   int8 mix with its plain version within one quantization step), the
   int8 wire at most 0.3x fp32's bytes; ``run()``'s four rows (the dense
   mix at [20, 65536], the SIMT flash at f32 [1, 4, 512, 64], the router
   at T = 2048, E = 64, k = 6, ``ssd_chunk_tc`` at [4, 4, 128, 64, 64]),
   one launch each, timed beside the plain version and the library call;
   the contract benches (``bench_superstep`` 20 epochs in chunks of 5,
   ``bench_quant_convergence`` 20, ``bench_fedavg_dispatch`` 12,
   ``bench_scenario_overhead`` 12, ``bench_geom_trust``,
   ``bench_corr_trust`` and ``bench_telemetry`` at 8 epochs of 10 local
   epochs): chunks within budget and equal across each bench's variants,
   equal kernel launches a round, int8 + EF21 within 0.02 of fp32; the
   wall ratios printed, not gated. [12c]: every gossip, router, flash and
   ssd_chunk shape [12] launched (``launched_kernel_shapes``) that [2]
   did not check is held against its plain version on fresh inputs.

Exits non-zero, before the last line, on any failure or without a card.
The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

REPLACES = {
    "gossip_mix": "src/repro/kernels/gossip_mix.py:40",
    "gossip_mix_sparse": "src/repro/kernels/gossip_mix_sparse.py:66",
    "gossip_mix_quant": "src/repro/kernels/gossip_mix_quant.py:68",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
    "flash_attention_tc": "src/repro/kernels/flash_attention.py:87",
    "moe_router": "src/repro/kernels/moe_router.py:45",
    "moe_route_slots": "src/repro/kernels/moe_router.py:45",
    "ssd_chunk_tc": "src/repro/kernels/ssd_chunk.py:44",
}
GOSSIP = ("gossip_mix", "gossip_mix_sparse", "gossip_mix_quant")
SERVING = ("flash_attention_tc", "moe_router", "moe_route_slots")
MAMBA2_PARAMS = 780_148_992             # repro.models.model.abstract_params
JAMBA_PERIOD_PARAMS = 13_267_656_416    # the same, jamba at num_layers=8
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def world_csr(w: int, k_peers: int, seed: int, dev):
    """A random k-out topology with self-loops and a row-stochastic P on it
    (about half the peers unsampled, i.e. zero weight, as in a round):
    returns P [W, W], idx [W, K] int32, val [W, K], nnz (non-pad slots)."""
    from repro_torch.core.gossip import sparse_support, sparse_weights
    rng = np.random.default_rng(seed)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        adj[i, rng.choice([j for j in range(w) if j != i], size=k_peers,
                          replace=False)] = True
    keep = (adj & (rng.random((w, w)) < 0.5)) | np.eye(w, dtype=bool)
    P = keep * rng.uniform(0.5, 1.5, (w, w))
    P = torch.tensor(P / P.sum(1, keepdims=True), dtype=torch.float32,
                     device=dev)
    idx, val = sparse_weights(P, adj)
    return P, idx, val.contiguous(), int(sparse_support(adj)[1].sum())


def payload(gen, w: int, f: int, dtype):
    x = torch.randn(w, f, generator=gen, device=gen.device)
    if dtype == "int8":
        from repro_torch.core.gossip import quantize_rows_int8
        return quantize_rows_int8(x)
    return x.to(getattr(torch, dtype)).contiguous(), None


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def kernel_calls(ops, ref, P, idx, val, w_in, scale):
    """(kernel call, plain call) per kernel for one payload; P None: the
    padded-CSR mixes alone (the gather branches' W, where no dense P is
    made)."""
    calls = {}
    if scale is None:
        if P is not None:
            calls["gossip_mix"] = (lambda: ops.gossip_mix(P, w_in),
                                   lambda: ref.gossip_mix_ref(P, w_in))
        if w_in.dtype != torch.int8:
            calls["gossip_mix_sparse"] = (
                lambda: ops.gossip_mix_sparse(idx, val, w_in),
                lambda: ref.gossip_mix_sparse_ref(idx, val, w_in))
    else:
        if P is not None:
            Pw = (P * scale[None, :]).contiguous()  # the pallas backend's fold
            calls["gossip_mix"] = (lambda: ops.gossip_mix(Pw, w_in),
                                   lambda: ref.gossip_mix_ref(Pw, w_in))
        calls["gossip_mix_quant"] = (
            lambda: ops.gossip_mix_quant(idx, val, scale, w_in),
            lambda: ref.gossip_mix_quant_ref(idx, val, scale, w_in))
    return calls


def gather_world(w: int, k: int, seed: int, dev):
    """idx [W, K] int32, val [W, K] for a large W without a dense P: slot 0
    the row itself, K - 2 random peers, the last slot a pad (val 0)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, w, size=(w, k)).astype(np.int32)
    idx[:, 0] = np.arange(w)
    idx[:, -1] = np.arange(w)
    val = rng.uniform(0.5, 1.5, size=(w, k))
    val[:, -1] = 0.0
    val /= val.sum(1, keepdims=True)
    return (torch.tensor(idx, device=dev),
            torch.tensor(val, dtype=torch.float32, device=dev))


# the padded-CSR mixes take their gather branches at K = 5 past W = 11,617
# (int8, ops.gossip_mix_quant_plan), 3,119 (f32) and 6,239 (bf16,
# ops.gossip_mix_sparse_plan)
GATHER_W = 12000


def expected_regime(ops, name, w, tag):
    """The regime or branch a gossip call must launch (ops.REGIMES key)."""
    if name == "gossip_mix":
        return "gossip_mix/" + ("stream" if w <= ops.GOSSIP_STREAM_MAX_W
                                else "tile")
    if name in ("gossip_mix_sparse", "gossip_mix_quant"):
        return name + ("/gather" if tag.startswith("gather") else "/slices")
    return None


def check_kernels(dev):
    """Every gossip mix against its plain version on every payload type:
    the main path's leaves (W = 22), the MLP's leaves in the scenario
    worlds (Table 3 at W = 60, K = 5; storm at W = 23), a ragged F, W in
    {48, 49} (both sides
    of the dense mix's regime boundary), W in {64, 65, 128, 129, 200} (both
    sides of the tile regime's 32-deep k step and 128-row tile; W = 49, 65
    and 129 leave P's rows unaligned), W =
    500 at F = 4096 and 4099, W = 1,000 at K = 100 (the sparse mix's slots
    no longer fit beside its slice: double-buffered slot groups) at F =
    2048 and 1001, and the sparse (f32, bf16) and int8 mixes at W = 12,000
    (their gather branches) at F = 4096 and 1001. Each call must
    launch once, in the regime or branch it should (``expected_regime``).
    Limit 1e-5 (1 + max|plain|) for every kernel and payload."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    # the main path's leaves: MLP(32, 10, hidden 64) and CNN(10, 1, 10, 8)
    for f in (2048, 64, 640, 10, 72, 1152):
        cases.append(("main", 22, 4, f))
    # the MLP's leaves in the Table 3 world (W = 60, K = 5: the dense mix's
    # tile regime, mostly ragged tiles at F = 640, 64 and 10) and in the
    # storm world (W = 23)
    for f in (2048, 640, 64, 10):
        cases += [("table3", 60, 4, f), ("storm", 23, 4, f)]
    # and in the cross-device cohort of the launcher's default (k = 64:
    # the tile regime, one 128-row tile half masked, F = 10 one ragged
    # column tile)
    for f in (2048, 640, 64, 10):
        cases.append(("cohort", 64, 4, f))
    cases += [("ragged", 22, 4, 1001), ("W48", 48, 16, 2048),
              ("W49", 49, 16, 1001), ("W64", 64, 21, 2048),
              ("W65", 65, 21, 1001), ("W128", 128, 42, 4096),
              ("W129", 129, 43, 2048), ("W200", 200, 66, 4099),
              ("w500", 500, 24, 4096), ("w500-ragged", 500, 24, 4099),
              ("groups", 1000, 99, 2048), ("groups-ragged", 1000, 99, 1001),
              ("gather", GATHER_W, 5, 4096),
              ("gather-ragged", GATHER_W, 5, 1001)]
    max_err = {k: 0.0 for k in GOSSIP}
    seen = set()
    for tag, w, kp, f in cases:
        if tag.startswith("gather"):
            P = None
            idx, val = gather_world(w, kp, seed=f, dev=dev)
        else:
            P, idx, val, _ = world_csr(w, kp, seed=w + f, dev=dev)
        for dtype in ("float32", "bfloat16", "int8"):
            w_in, scale = payload(gen, w, f, dtype)
            for name, (kern, plain) in kernel_calls(
                    ops, ref, P, idx, val, w_in, scale).items():
                before, regimes = ops.LAUNCHES[name], dict(ops.REGIMES)
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                regime = expected_regime(ops, name, w, tag)
                launched = {k: v - regimes.get(k, 0)
                            for k, v in ops.REGIMES.items()
                            if v != regimes.get(k, 0)}
                if ops.LAUNCHES[name] - before != 1 or (
                        regime is not None and launched != {regime: 1}):
                    fail(f"{name} {tag} {dtype}: launches {launched}, "
                         f"expected one in {regime}")
                seen.add(regime)
                if got.shape != want.shape or got.dtype != torch.float32:
                    fail(f"{name} {tag} {dtype}: shape/dtype {got.shape} "
                         f"{got.dtype}")
                err = float((got - want).abs().max())
                tol = 1e-5 * (1.0 + float(want.abs().max()))
                print(f"  check {name:18s} {tag:13s} W={w:5d} F={f:5d} "
                      f"{dtype:8s} max_abs_err={err:.3e} tol={tol:.1e}"
                      f"{'' if regime is None else ' ' + regime}")
                if not err <= tol:
                    fail(f"{name} disagrees with its plain version")
                max_err[name] = max(max_err[name], err)
                CHECKED.add(gossip_key(name, idx, w_in))
    want_seen = {"gossip_mix/stream", "gossip_mix/tile",
                 "gossip_mix_sparse/slices", "gossip_mix_sparse/gather",
                 "gossip_mix_quant/slices", "gossip_mix_quant/gather"}
    if not want_seen <= seen:
        fail(f"gossip regimes launched {sorted(seen - {None})}, expected "
             f"{sorted(want_seen)}")
    return max_err


def check_identity_rows(dev):
    """The cohort's identity rows in the dense mix's tile regime (k = 64,
    the MLP's leaves): rows of P that are e_i (the ``k_min`` fallback, a
    vacancy pad slot) beside rows that mix, for every payload (int8: P's
    columns scaled by the row scales, as the pallas backend folds them).
    Every output is finite, within the usual limit of the plain version,
    and on a bf16 payload (exact in TF32) an identity row returns its input
    row bit for bit."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    w, eye_rows = 64, torch.arange(0, 64, 3, device=dev)
    for f in (2048, 640, 64, 10):
        P, _, _, _ = world_csr(w, 4, seed=f, dev=dev)
        P[eye_rows] = 0.0
        P[eye_rows, eye_rows] = 1.0
        for dtype in ("float32", "bfloat16", "int8"):
            x, scale = payload(gen, w, f, dtype)
            Pw = (P * scale[None, :]).contiguous() if scale is not None \
                else P
            before = dict(ops.REGIMES)
            got = ops.gossip_mix(Pw, x)
            torch.cuda.synchronize()
            want = ref.gossip_mix_ref(Pw, x)
            err = float((got - want).abs().max())
            tol = 1e-5 * (1.0 + float(want.abs().max()))
            rows_exact = torch.equal(got[eye_rows], x[eye_rows].float())
            print(f"  check gossip_mix identity rows W={w} F={f:5d} "
                  f"{dtype:8s} max_abs_err={err:.3e} tol={tol:.1e} "
                  f"identity rows bit-equal={rows_exact}")
            if ops.REGIMES.get("gossip_mix/tile", 0) - \
                    before.get("gossip_mix/tile", 0) != 1:
                fail(f"gossip_mix identity rows F={f}: not in the tile "
                     f"regime")
            if not (bool(got.isfinite().all()) and err <= tol and (
                    rows_exact or dtype != "bfloat16")):
                fail(f"gossip_mix identity rows F={f} {dtype}: finite "
                     f"{bool(got.isfinite().all())}, error {err} (limit "
                     f"{tol}), identity rows bit-equal {rows_exact}")


def check_sparse_nonfinite(dev):
    """The sparse mix folds every slot, weight 0 included, as the TPU kernel
    does: a zero-weight slot that names a row holding inf adds 0 * inf =
    NaN. At W = 22 and 500 (slices: an unsampled peer's slot) and at
    ``GATHER_W`` (gather: the pad slot, which names the row itself), f32
    and bf16, the kernel's NaN and inf masks must equal the plain
    version's, with NaN where the slot points, and the finite values agree
    within the usual limit."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for tag, w, kp, f in (("slices", 22, 4, 72), ("slices", 500, 24, 4099),
                          ("gather", GATHER_W, 5, 1001)):
        if tag == "gather":
            idx, val = gather_world(w, kp, seed=f, dev=dev)
            i, kk = 0, kp - 1                 # the pad slot: row 0 itself
        else:
            _, idx, val, _ = world_csr(w, kp, seed=w + f, dev=dev)
            zero = (val == 0) & (idx != torch.arange(w, device=dev)[:, None])
            i, kk = (int(t) for t in zero.nonzero()[0])
        j = int(idx[i, kk])
        for dtype in ("float32", "bfloat16"):
            x, _ = payload(gen, w, f, dtype)
            x[j, 3:9] = float("inf")
            before = dict(ops.REGIMES)
            got = ops.gossip_mix_sparse(idx, val, x)
            torch.cuda.synchronize()
            want = ref.gossip_mix_sparse_ref(idx, val, x)
            fin = want.isfinite()
            err = float((got[fin] - want[fin]).abs().max())
            tol = 1e-5 * (1.0 + float(want[fin].abs().max()))
            n_nan = int(want.isnan().sum())
            print(f"  check gossip_mix_sparse inf row W={w:5d} F={f:4d} "
                  f"{dtype:8s} slot ({i}, {kk}) -> row {j} weight "
                  f"{float(val[i, kk]):.1f}: NaN {n_nan} (plain), finite "
                  f"max_abs_err={err:.3e} tol={tol:.1e}")
            if ops.REGIMES.get(f"gossip_mix_sparse/{tag}", 0) - \
                    before.get(f"gossip_mix_sparse/{tag}", 0) != 1:
                fail(f"gossip_mix_sparse inf row W={w}: not in its {tag} "
                     f"branch")
            if not (torch.equal(got.isnan(), want.isnan())
                    and torch.equal(got.isinf(), want.isinf())
                    and bool(want[i, 3:9].isnan().all()) and err <= tol):
                fail("gossip_mix_sparse: a zero-weight slot on an inf row "
                     "gives another result than the plain version")


# ---------------------------------------------------------------------------
# Phase 3: timings
# ---------------------------------------------------------------------------

def device_ms(fn, calls: int = 50, repeats: int = 7) -> float:
    """Median device milliseconds per call: ``calls`` back-to-back calls
    captured in one CUDA graph (so host overhead does not show), replayed
    ``repeats`` times between CUDA events, after a warm-up."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


# The five bounds live in launch/roofline.py, built from the kernels' costs
# (kernels/cost.py); they are imported at call time, after main() has put
# src/ on the path.
def bound(name, w, k_nnz, k_slots, f, in_bytes, tensor_cores=False):
    """``launch.roofline.bound`` (the kernel costs' one source)."""
    from repro_torch.launch import roofline
    return roofline.bound(name, w, k_nnz, k_slots, f, in_bytes,
                          tensor_cores=tensor_cores)


def time_kernels(dev, tag, w, kp, f):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    P, idx, val, nnz = world_csr(w, kp, seed=7, dev=dev)
    w32, _ = payload(gen, w, f, "float32")
    w16, _ = payload(gen, w, f, "bfloat16")
    q, scale = payload(gen, w, f, "int8")
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.arange(w, device=dev).repeat_interleave(
            idx.shape[1]), idx.reshape(-1).long()]), val.reshape(-1),
        (w, w)).coalesce().to_sparse_csr()
    rows = {
        "gossip_mix": (lambda: ops.gossip_mix(P, w32),
                       lambda: ref.gossip_mix_ref(P, w32),
                       lambda: torch.matmul(P, w32), 4),
        "gossip_mix_sparse": (lambda: ops.gossip_mix_sparse(idx, val, w32),
                              lambda: ref.gossip_mix_sparse_ref(idx, val,
                                                                w32),
                              lambda: torch.sparse.mm(csr, w32), 4),
        "gossip_mix_quant": (
            lambda: ops.gossip_mix_quant(idx, val, scale, q),
            lambda: ref.gossip_mix_quant_ref(idx, val, scale, q), None, 1),
    }
    out = {}
    for name, (kern, plain, lib, in_bytes) in rows.items():
        ms, plain_ms = device_ms(kern), device_ms(plain)
        lib_ms = device_ms(lib) if lib is not None else None
        tile = name == "gossip_mix" and \
            ops.gossip_mix_plan(w, f, w32.dtype)[0] == "tile"
        b_ms, b_by = bound(name, w, nnz, idx.shape[1], f, in_bytes, tile)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
        both = ""
        if name == "gossip_mix":    # the bound both ways
            cc = bound(name, w, nnz, idx.shape[1], f, in_bytes)
            tc = bound(name, w, nnz, idx.shape[1], f, in_bytes, True)
            both = (f" [fp32 CUDA cores {cc[0] * 1e3:.2f}us ({cc[1]}), "
                    f"3xTF32 tensor cores {tc[0] * 1e3:.2f}us ({tc[1]}); "
                    f"{'tile' if tile else 'stream'} regime]")
        print(f"  time {name:18s} {tag:5s} W={w:3d} K={idx.shape[1]:2d} "
              f"F={f:5d} kernel={ms * 1e3:9.2f}us plain={plain_ms * 1e3:9.2f}"
              f"us library={'-' if lib_ms is None else f'{lib_ms * 1e3:.2f}'}"
              f"us bound={b_ms * 1e3:.2f}us ({b_by}){both}")
    ms = device_ms(lambda: ops.gossip_mix_sparse(idx, val, w16))
    plain_ms = device_ms(lambda: ref.gossip_mix_sparse_ref(idx, val, w16))
    b_ms, b_by = bound("gossip_mix_sparse", w, nnz, idx.shape[1], f, 2)
    print(f"  time {'gossip_mix_sparse':18s} {tag:5s} W={w:3d} "
          f"K={idx.shape[1]:2d} F={f:5d} kernel={ms * 1e3:9.2f}us plain="
          f"{plain_ms * 1e3:9.2f}us bound={b_ms * 1e3:.2f}us ({b_by}) "
          f"[bf16 payload]")
    return out


def flash_err(got, want, dtype):
    """The SIMT kernel's limit: (max |got - want|, its worst ratio to the
    limit) over the elements. f32: 5e-5 (the JAX package's bound). bf16:
    one ulp of each element, |want| * 2**-7 (ulp(x) <= |x| * 2**-7),
    + 1e-5: both compute in fp32 (they agree within 1e-6 in f32) and round
    once to bf16, so they differ by at most one rounding step of the
    element itself."""
    err = (got.float() - want.float()).abs()
    lim = 5e-5 if dtype == torch.float32 \
        else want.float().abs() * 2.0 ** -7 + 1e-5
    return float(err.max()), float((err / lim).max())


def main_path_qkv(gen, b, s, dev, h=16, dtype=torch.bfloat16, d=128):
    """q, k, v as attention.py hands them to the kernel: [B, H, S, D]
    views of [B, S, H, D] tensors (bf16 at D = 128 by default:
    DeepSeekMoE-16B's 16 heads; Jamba's 32)."""
    return tuple(torch.randn(b, s, h, d, generator=gen, device=dev)
                 .to(dtype).transpose(1, 2) for _ in range(3))


def kimi_qkv(gen, b, s, dev, h=64, hkv=8, d=112):
    """q, k, v as attention.py hands Kimi-K2's (``configs/kimi_k2_1t_a32b``:
    64 query heads over 8 kv heads, D = 112, bf16) to the kernel: k and v
    repeated to the query heads (``repeat_interleave``), all three [B, H, S,
    D] views of [B, S, H, D] tensors."""
    q = torch.randn(b, s, h, d, generator=gen, device=dev)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device=dev)
            .repeat_interleave(h // hkv, dim=2) for _ in range(2))
    return tuple(t.to(torch.bfloat16).transpose(1, 2) for t in (q, k, v))


def cross_qkv(gen, b, h, sq, sk, d, dev, dtype=torch.bfloat16):
    """q [B, H, Sq, D] and k, v [B, H, Sk, D] as the whisper model hands
    them to the kernel: views of [B, S, H, D] tensors of their own
    length."""
    q = torch.randn(b, sq, h, d, generator=gen, device=dev)
    k, v = (torch.randn(b, sk, h, d, generator=gen, device=dev)
            for _ in range(2))
    return tuple(t.to(dtype).transpose(1, 2) for t in (q, k, v))


# (label, dtype, B, H / tp, S) of the flash calls of the tensor-parallel
# main paths at full width ([10] and [11]: a model shard's query heads,
# D = 128, views of the shard's [B, S, H / tp, D] projections; the data
# axis's coordinate 0 runs the whole batch). The reduced models' calls in
# [11] are checked after it (``check_launched_shapes``)
TP_FLASH = (("10 qwen3-0.6b train_4k shard tp=4", torch.bfloat16, 2, 4, 4096),
            ("10 deepseek-moe-16b prefill_32k B=8 shard tp=4",
             torch.bfloat16, 8, 4, 4096),
            ("10 deepseek-moe-16b prefill_32k B=1 shard tp=4",
             torch.bfloat16, 1, 4, 32768),
            ("11 qwen3-0.6b bf16 train step shard tp=4", torch.bfloat16, 2,
             4, 512),
            ("11 qwen3-0.6b f32 prefill shard tp=4", torch.float32, 2, 4,
             128))
# the plain version computes this many queries at a time above it, so
# that S = 32768's scores are never held whole
REF_ROWS = 4096


# (label, B, H, Sq, Sk, D, causal) of the flash calls of the whisper-tiny
# (B = 4, 1,500 frames, 448 tokens) and InternVL2-2B (B = 4, 256 vision +
# 512 text tokens) prefills of phase [8]
ENCDEC_FLASH = (("whisper encoder", 4, 6, 1500, 1500, 64, False),
                ("whisper cross", 4, 6, 448, 1500, 64, False),
                ("whisper decoder", 4, 6, 448, 448, 64, True),
                ("internvl2-2b", 4, 16, 768, 768, 128, True))


def check_flash(dev):
    """flash_attention against its plain version, each call checked to
    launch the kernel its dtype and D select (``ops.flash_kernel``): S in
    {17 (shorter than a tile), 64, 200 (ragged), 256, 512, 1000 (ragged),
    4096}, D in {64, 128}, causal / window 128 / non-causal, f32 (SIMT,
    ``flash_err``) and bf16 (tensor cores, ``ref.flash_tc_limit``); bf16
    at D = 32 (SIMT, ``flash_err``); the four adversarial cases of
    ``ref.flash_adversarial`` at both D; the main path's two prefill
    shapes and Jamba's [1, 32, 4096, 128] in its layout (``main_path_qkv``),
    causal, window 0; whisper's shapes (``cross_qkv``, D = 64, 6 heads):
    cross-attention with k and v of their own length, Sq in {1, 17, 448}
    over Sk in {64, 1500}, and the encoder's non-causal S = 1500, f32
    (SIMT) and bf16 (tensor cores); the SIMT kernel at the reduced
    whisper's D = 42 (f32 and bf16: the columns past D masked in the
    kernel), causal, window 16, non-causal and across lengths; and the four
    flash calls of the phase [8] prefills at their own shapes, B = 4 and
    causal flag, in the model's layout (``ENCDEC_FLASH``, bf16). Returns
    the worst max |error| of each kernel."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = []
    for s in (17, 64, 200, 256, 512, 1000, 4096):
        b, h = (2, 4) if s <= 1000 else (1, 2)
        for d in (64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                qkv = tuple(torch.randn(b, h, s, d, generator=gen,
                                        device=dev).to(dtype)
                            for _ in range(3))
                cases += [("", qkv, causal, window) for causal, window in
                          ((True, 0), (True, 128), (False, 0))]
    qkv = tuple(torch.randn(2, 4, 200, 32, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(3))
    cases += [("D=32", qkv, causal, window) for causal, window in
              ((True, 0), (True, 128), (False, 0))]
    for kind in ref.FLASH_ADVERSARIAL:
        for d in (64, 128):
            *qkv, causal, window = ref.flash_adversarial(kind, d, seed=d,
                                                         device=dev)
            cases.append((f"adversarial {kind}",
                          tuple(x.to(torch.bfloat16) for x in qkv), causal,
                          window))
    for b, s, h in ((4, 512, 16), (1, 4096, 16), (1, 4096, 32)):
        cases.append(("main-path strided" if h == 16 else
                      "jamba strided", main_path_qkv(gen, b, s, dev, h),
                      True, 0))
    for tag, dtype, b, h, s in TP_FLASH:
        cases.append((tag, main_path_qkv(gen, b, s, dev, h, dtype), True, 0))
    for dtype in (torch.float32, torch.bfloat16):
        for sq in (1, 17, 448):
            for sk in (64, 1500):
                cases.append((f"cross Sk={sk}", cross_qkv(
                    gen, 2, 6, sq, sk, 64, dev, dtype), False, 0))
        cases.append(("encoder S=1500", cross_qkv(
            gen, 2, 6, 1500, 1500, 64, dev, dtype), False, 0))
        for sq, sk in ((200, 200), (17, 64)):
            for causal, window in ((True, 0), (True, 16), (False, 0)):
                if sq == sk or not (causal or window):
                    cases.append(("D=42", cross_qkv(
                        gen, 2, 6, sq, sk, 42, dev, dtype), causal, window))
    for label, b, h, sq, sk, d, causal in ENCDEC_FLASH:
        cases.append((f"{label} prefill", cross_qkv(gen, b, h, sq, sk, d,
                                                    dev), causal, 0))
    # the SIMT kernel at Kimi-K2's full-width call, bf16 at D in {80, 96}
    # (ragged, split and across lengths) and the adversarial cases in f32
    # and in bf16 at D = 96
    cases.append(("kimi-k2 strided", kimi_qkv(gen, 1, 4096, dev), True, 0))
    for d in (80, 96):
        for b, h, sq, sk in ((2, 6, 200, 200), (1, 2, 1000, 1000),
                             (2, 6, 17, 1500)):
            for causal, window in ((True, 0), (True, 128), (False, 0)):
                if sq == sk or not (causal or window):
                    cases.append((f"D={d}", cross_qkv(
                        gen, b, h, sq, sk, d, dev), causal, window))
    for kind in ref.FLASH_ADVERSARIAL:
        for d, dtype in ((64, torch.float32), (128, torch.float32),
                         (96, torch.bfloat16)):
            *qkv, causal, window = ref.flash_adversarial(kind, d, seed=d,
                                                         device=dev)
            cases.append((f"adversarial {kind}",
                          tuple(x.to(dtype) for x in qkv), causal, window))
    worst = {"flash_attention": 0.0, "flash_attention_tc": 0.0}
    worst_ratio = dict(worst)
    for tag, (q, k, v), causal, window in cases:
        name, err, ratio = flash_case(tag, q, k, v, causal, window)
        worst[name] = max(worst[name], err)
        worst_ratio[name] = max(worst_ratio[name], ratio)
    print(f"  flash worst err/limit: {worst_ratio}")
    return worst


# the shape keys of the kernel calls held against their plain versions
# (``flash_key``, ``ssd_key``, ``gossip_key``, ``router_key``)
CHECKED = set()


def gossip_key(name, idx, w_in):
    """A gossip mix's shape key: (kernel, payload dtype, W, F) for the
    dense mix, (kernel, payload dtype, W, K, F) for the padded-CSR ones."""
    dtype = str(w_in.dtype)[6:]
    if name == "gossip_mix":
        return (name, dtype, *w_in.shape)
    return (name, dtype, w_in.shape[0], idx.shape[1], w_in.shape[1])


def flash_key(q, k, causal, window):
    return ("flash", str(q.dtype)[6:], *q.shape, k.shape[2], causal, window)


def ssd_key(args):
    g, h, t, p = args[4].shape
    return ("ssd", g, h, t, args[0].shape[-1], p)


def flash_case(tag, q, k, v, causal, window):
    """One flash_attention call against its plain version: it must launch
    the kernel its dtype and D select, once, and agree within that
    kernel's limit (``ref.flash_tc_limit`` for the tensor cores,
    ``flash_err`` for SIMT). Returns (kernel, max |error|, worst
    error/limit)."""
    from repro_torch.kernels import ops, ref
    kernels = ("flash_attention", "flash_attention_tc")
    name = ops.flash_kernel(q.dtype, q.shape[-1])
    rows = REF_ROWS if q.shape[2] > REF_ROWS else 0
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   rows=rows)
    torch.cuda.synchronize()
    launched = {n: ops.LAUNCHES[n] - before[n] for n in kernels}
    if name == "flash_attention_tc":
        lim = ref.flash_tc_limit(q, k, v, want, causal=causal,
                                 window=window, rows=rows)
        diff = (got.float() - want.float()).abs()
        err, ratio = float(diff.max()), float((diff / lim).max())
    else:
        err, ratio = flash_err(got, want, q.dtype)
    sk = f" Sk={k.shape[2]}" if k.shape[2] != q.shape[2] else ""
    print(f"  check {name:18s} {list(q.shape)}{sk} "
          f"{str(q.dtype)[6:]:8s} causal={causal:d} window={window:3d} "
          f"max_abs_err={err:.3e} worst_err/limit={ratio:.3f} {tag}")
    if launched != {n: int(n == name) for n in kernels}:
        fail(f"flash_attention {tag}: launches {launched}, expected one "
             f"of {name}")
    if got.dtype != q.dtype or got.shape != q.shape or not ratio <= 1.0:
        fail(f"{name} disagrees with its plain version")
    CHECKED.add(flash_key(q, k, causal, window))
    return name, err, ratio


def router_rows(gen, t, e, dev, dtype):
    """Normal logits; every third row has an exact tie across the top
    (half the experts at 6.0), every fifth row rounded logits (ties inside
    the top-k). Returns (logits, mask of tie rows)."""
    x = torch.randn(t, e, generator=gen, device=dev)
    x[::3, : e // 2] = 6.0
    x[1::5] = torch.round(x[1::5])
    ties = torch.zeros(t, dtype=torch.bool, device=dev)
    ties[::3] = True
    ties[1::5] = True
    return x.to(dtype), ties


ROUTER_CASES = [(t, e, k) for t in (4, 1000, 2048, 4096, 32768)
                for e, k in ((64, 6), (16, 2))] + \
    [(t, e, k) for t in (4, 4096) for e, k in ((128, 8), (512, 32))]


def check_router(dev):
    """moe_router against its plain version (``router_case``): T in {4,
    1000, 2048, 4096, 32768} at (E, k) in {(64, 6), (16, 2)}, and T in {4,
    4096} at (E, k) in {(128, 8), (512, 32)} (16 and 32 lanes a row), f32
    and bf16 logits; no more than two rows with swapped indices in all.
    Returns the worst gate error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst, swaps = 0.0, 0
    for t, e, k in ROUTER_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            err, bad = router_case(gen, t, e, k, dtype, dev)
            swaps += bad
            worst = max(worst, err)
    if swaps > 2:
        fail(f"moe_router: {swaps} rows with swapped indices")
    return worst


def router_key(logits, k):
    return ("router", str(logits.dtype)[6:], *logits.shape, k)


def router_case(gen, t, e, k, dtype, dev):
    """One moe_router call on ``router_rows`` against its plain version.
    Indices must be equal, except that on a row of random logits two
    experts whose fp32 probabilities round to within 1e-6 may swap (the two
    softmaxes sum in another order); the gates of such a swap still agree.
    Rows with exact ties must match exactly. Gates within 1e-6. Returns
    (gate error, rows whose indices differ)."""
    from repro_torch.kernels import ops, ref
    x, ties = router_rows(gen, t, e, dev, dtype)
    gates, idx = ops.moe_router_topk(x, k)
    wgates, widx = ref.moe_router_topk_ref(x, k)
    torch.cuda.synchronize()
    err = float((gates - wgates).abs().max())
    bad = (idx != widx).any(dim=1)
    print(f"  check moe_router T={t:5d} E={e:3d} k={k:2d} "
          f"{str(dtype)[6:]:8s} gate_max_abs_err={err:.3e} "
          f"tol=1.0e-06 idx_rows_differ={int(bad.sum())}")
    if idx.dtype != torch.int32 or not err <= 1e-6 \
            or bool((bad & ties).any()):
        fail("moe_router disagrees with its plain version")
    CHECKED.add(router_key(x, k))
    return err, int(bad.sum())


def graph_outputs(fn):
    """``fn``'s outputs from an eager call and from two replays of a CUDA
    graph that captured it (after warm-up calls on a side stream)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        eager = [t.clone() for t in fn()]
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    replays = []
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in out])
    return eager, replays


def check_route_slots(dev):
    """The fused route-and-slot kernel against its plain version on
    ``check_router``'s cases, on T = 32768 (1024 tiles of 32 rows, many
    look-back windows) and on routers skewed to overflow the capacity
    (expert 3 raised by 4 on 80 % of the rows), f32 and bf16, at
    ``moe_grouped``'s capacity. Gates and indices as ``check_router``
    holds the router (gates within 1e-6; at most 2 rows with swapped
    near-equal indices over all cases, none on a tie row) and bit-equal
    to the router kernel's on the same logits (the same per-row code);
    slot and the inverse map src exactly ``ref.route_slots_ref`` of the
    kernel's own indices; a second call and two CUDA graph replays equal
    to the first. Returns the worst gate error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import grouped_capacity
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst, swaps = 0.0, 0
    cases = [(t, e, k, kind) for t in (4, 1000, 2048, 4096, 32768)
             for e, k in ((64, 6), (16, 2)) for kind in ("ties", "skewed")]
    for t, e, k, kind in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, ties = router_rows(gen, t, e, dev, torch.float32)
            if kind == "skewed":
                x[torch.rand(t, generator=gen, device=dev) < 0.8, 3] += 4.0
            x = x.to(dtype)
            cap = grouped_capacity(t, e, k)
            got = ops.moe_route_slots(x, k, cap)
            again = ops.moe_route_slots(x, k, cap)
            gates, idx, slot, src = got
            rgates, ridx = ops.moe_router_topk(x, k)
            wgates, widx = ref.moe_router_topk_ref(x, k)
            wslot, wsrc = ref.route_slots_ref(idx, e, cap)
            torch.cuda.synchronize()
            err = float((gates - wgates).abs().max())
            bad = (idx != widx).any(dim=1)
            dropped = int((slot == cap).sum())
            print(f"  check moe_route_slots T={t:5d} E={e:2d} k={k} "
                  f"cap={cap:5d} {kind:6s} {str(dtype)[6:]:8s} "
                  f"gate_max_abs_err={err:.3e} tol=1.0e-06 "
                  f"idx_rows_differ={int(bad.sum())} dropped={dropped}")
            if not (err <= 1e-6 and not bool((bad & ties).any())):
                fail("moe_route_slots: gates or indices disagree with the "
                     "plain version")
            if not (torch.equal(gates, rgates) and torch.equal(idx, ridx)):
                fail("moe_route_slots: gates or indices differ from the "
                     "router kernel's")
            if not (torch.equal(slot, wslot) and torch.equal(src, wsrc)):
                fail("moe_route_slots: slots disagree with the plain rank "
                     "of the kernel's own indices")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail("moe_route_slots: two calls differ")
            if kind == "skewed" and t >= 1000 and not dropped:
                fail("moe_route_slots: the skewed case does not overflow")
            swaps += int(bad.sum())
            worst = max(worst, err)
    if swaps > 2:
        fail(f"moe_route_slots: {swaps} rows with swapped indices")
    x, _ = router_rows(gen, 4096, 64, dev, torch.float32)
    eager, replays = graph_outputs(
        lambda: ops.moe_route_slots(x, 6, grouped_capacity(4096, 64, 6)))
    if not all(torch.equal(a, b) for r in replays for a, b in zip(eager, r)):
        fail("moe_route_slots: a CUDA graph replay differs from the eager "
             "call")
    print("  check moe_route_slots T=4096 E=64 k=6 in a CUDA graph: two "
          "replays equal to the eager call")
    return worst


def check_grouped_capture(dev):
    """One grouped MoE layer (``moe_grouped`` at the reduced DeepSeekMoE's
    shapes, f32, T = 96) captured in a CUDA graph, which fails on any
    host synchronisation; two replays equal to the eager call."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.models import layers, moe
    cfg = reduced(get_config("deepseek-moe-16b"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    b = layers.Builder(gen, torch.float32, dev)
    moe.init_moe(b, cfg)
    x = torch.randn(96, cfg.d_model, generator=gen, device=dev)
    eager, replays = graph_outputs(lambda: moe.moe_grouped(b.params, cfg, x))
    if not all(torch.equal(a, b) for r in replays for a, b in zip(eager, r)):
        fail("moe_grouped: a CUDA graph replay differs from the eager call")
    print(f"  check moe_grouped captured in a CUDA graph (E="
          f"{cfg.moe.num_experts}, k={cfg.moe.top_k}, T=96): two replays "
          f"equal to the eager call")


def flash_bound(b, h, s, d, itemsize, causal=True, sk=None):
    """``launch.roofline.flash_bound`` (the kernel costs' one source)."""
    from repro_torch.launch import roofline
    return roofline.flash_bound(b, h, s, d, itemsize, causal=causal, sk=sk)


def router_bound(t, e, k, itemsize):
    """``launch.roofline.router_bound`` (the kernel costs' one source)."""
    from repro_torch.launch import roofline
    return roofline.router_bound(t, e, k, itemsize)


def simt_flash(q, k, v, causal=True):
    """The SIMT flash kernel through its C entry (window 0), on any dtype
    and D it takes; bypasses ``ops`` and its launch counter, so it times
    the SIMT kernel on shapes the wrapper sends to the tensor cores."""
    from repro_torch.kernels import build, ops
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    rc = build.load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, h,
        sq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
        *out.stride()[:3], int(causal), 0, ops._DTYPE_CODE[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"SIMT flash launch failed (cudaError {rc})")
    return out


def time_serving_kernels(dev):
    """Flash attention at the prefill shapes and layout
    (``main_path_qkv``: [4, 16, 512, 128] and [1, 16, 4096, 128], bf16,
    causal): the tensor-core kernel (timed first and last), the SIMT
    kernel through its C entry, SDPA and the plain version, in one call;
    and the router at T = 2048 (prefill B=4 x S=512), 4096, 4 (a decode
    step) and 32768 (expert parallelism's replicated path at DeepSeekMoE's
    prefill_32k, [10]), E = 64, k = 6, f32 logits, beside the floor of
    ``device_ms`` (a one-element in-place ``add_``). Returns the rows of
    the first shape of each."""
    from repro_torch.kernels import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    out = {}
    for b, s in ((4, 512), (1, 4096)):
        q, k, v = main_path_qkv(gen, b, s, dev)
        calls = 50 if s <= 512 else 5
        ms = device_ms(lambda: ops.flash_attention(q, k, v), calls)
        simt_ms = device_ms(lambda: simt_flash(q, k, v), calls)
        lib_ms = device_ms(lambda: sdpa(q, k, v, is_causal=True), calls)
        plain_ms = device_ms(lambda: ref.flash_attention_ref(q, k, v),
                             calls)
        ms_again = device_ms(lambda: ops.flash_attention(q, k, v), calls)
        b_ms, b_by = flash_bound(b, 16, s, 128, 2)
        tflops = 4 * b * 16 * (s * (s + 1) // 2) * 128 / (ms * 1e-3) / 1e12
        print(f"  time flash_attention_tc [{b},16,{s},128] bf16 strided "
              f"causal kernel={ms * 1e3:.2f}us (again {ms_again * 1e3:.2f}"
              f"us, {tflops:.1f} TFLOP/s) simt={simt_ms * 1e3:.2f}us "
              f"plain={plain_ms * 1e3:.2f}us library(sdpa)="
              f"{lib_ms * 1e3:.2f}us bound={b_ms * 1e3:.2f}us ({b_by}) "
              f"simt/tc={simt_ms / ms:.2f} tc/sdpa={ms / lib_ms:.3f}")
        # the routing's ground: where bf16 at D = 128 goes to the TMA +
        # wgmma kernel, it beats the SIMT kernel (now on the tensor cores
        # too, so the 5x of a CUDA-core SIMT kernel no longer holds)
        if not simt_ms > ms:
            fail(f"flash_attention_tc at [{b},16,{s},128] is not faster "
                 f"than the SIMT kernel ({ms:.4f} vs {simt_ms:.4f} ms)")
        row = {"plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        out.setdefault("flash_attention_tc", dict(row, ms=ms))
        out.setdefault("flash_attention", dict(row, ms=simt_ms))
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(lambda: one.add_(1.0))
    print(f"  time floor: a one-element add_ {floor_ms * 1e3:.2f}us (the "
          f"least a launch costs in device_ms)")
    for t in (2048, 4096, 4, 32768):
        x = torch.randn(t, 64, generator=gen, device=dev)
        ms = device_ms(lambda: ops.moe_router_topk(x, 6))
        plain_ms = device_ms(lambda: ref.moe_router_topk_ref(x, 6))
        b_ms, b_by = router_bound(t, 64, 6, 4)
        print(f"  time moe_router T={t:5d} E=64 k=6 f32 kernel="
              f"{ms * 1e3:.2f}us plain={plain_ms * 1e3:.2f}us library=- "
              f"bound={b_ms * 1e3:.3f}us ({b_by}) above the floor="
              f"{(ms - floor_ms) * 1e3:.2f}us")
        out.setdefault("moe_router", {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by})
    return out


def time_encdec_flash(dev):
    """The tensor-core flash kernel at the whisper and InternVL shapes
    (``ENCDEC_FLASH``, bf16 views of [B, S, H, D] tensors as the model hands
    them), the SIMT kernel through its C entry, the plain version and SDPA
    on the same inputs, with the bytes/flops bound of each shape (their
    agreement with the plain version is ``check_flash``'s)."""
    from repro_torch.kernels import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    for label, b, h, sq, sk, d, causal in ENCDEC_FLASH:
        q, k, v = cross_qkv(gen, b, h, sq, sk, d, dev)
        ms = device_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                       20)
        simt_ms = device_ms(lambda: simt_flash(q, k, v, causal), 5)
        lib_ms = device_ms(lambda: sdpa(q, k, v, is_causal=causal), 20)
        plain_ms = device_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), 5)
        b_ms, b_by = flash_bound(b, h, sq, d, 2, causal, sk)
        print(f"  time flash_attention_tc {label} [{b},{h},{sq},{d}] Sk={sk} "
              f"bf16 causal={causal:d} kernel={ms * 1e3:.2f}us simt="
              f"{simt_ms * 1e3:.2f}us plain={plain_ms * 1e3:.2f}us "
              f"library(sdpa)={lib_ms * 1e3:.2f}us bound={b_ms * 1e3:.2f}us "
              f"({b_by}) bound/kernel={b_ms / ms:.3f} tc/sdpa="
              f"{ms / lib_ms:.3f}")


# (label, dtype, B, H, Sq, Sk, D, causal) of the SIMT kernel's timed calls:
# the f32 main paths' (the full-width qwen3-0.6b prefill's TP shard, the
# ~100M example's training forward, the harness's run() row, whisper's f32
# encoder and cross-attention), Kimi-K2's bf16 call and the C entry at the
# serving path's bf16 [64, 512, 128]
SIMT_TIMED = (("qwen3-0.6b f32 prefill shard", torch.float32, 2, 4, 128, 128,
               128, True),
              ("port_train_federated f32", torch.float32, 4, 12, 128, 128, 64,
               True),
              ("harness run() f32", torch.float32, 1, 4, 512, 512, 64, True),
              ("whisper f32 encoder", torch.float32, 4, 6, 1500, 1500, 64,
               False),
              ("whisper f32 cross", torch.float32, 4, 6, 448, 1500, 64, False),
              ("kimi-k2 bf16", torch.bfloat16, 1, 64, 4096, 4096, 112, True),
              ("C entry bf16", torch.bfloat16, 4, 16, 512, 512, 128, True))


def simt_inputs(gen, label, dtype, b, h, sq, sk, d, dev):
    """A ``SIMT_TIMED`` call's q, k, v in its caller's layout: the
    harness's one contiguous tensor as q, k and v; Kimi-K2's
    (``kimi_qkv``); the others [B, H, S, D] views of [B, S, H, D]
    tensors."""
    if label.startswith("harness"):
        q = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
        return q, q, q
    if label.startswith("kimi"):
        return kimi_qkv(gen, b, sq, dev, h=h, d=d)
    return cross_qkv(gen, b, h, sq, sk, d, dev, dtype)


def time_simt_flash(dev):
    """The SIMT flash kernel at ``SIMT_TIMED``, beside the plain version and
    SDPA in the same dtype: device us a call, the split count, the bound
    of ``flash_bound`` (f32 at the fp32 CUDA-core rate, bf16 at the bf16
    tensor-core rate) and, for f32, at the 3xTF32 rate (three TF32 products
    per product at 495 TFLOP/s). Returns the rows by label."""
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.launch import roofline
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = {}
    for label, dtype, b, h, sq, sk, d, causal in SIMT_TIMED:
        q, k, v = simt_inputs(gen, label, dtype, b, h, sq, sk, d, dev)
        calls = 20 if b * h * sq * sk <= 2 ** 26 else 3
        if label.startswith("C entry"):      # the wrapper picks flash_tc
            kern = lambda: simt_flash(q, k, v, causal)
        else:
            kern = lambda: ops.flash_attention(q, k, v, causal=causal)
        ms = device_ms(kern, calls)
        lib_ms = device_ms(lambda: sdpa(q, k, v, is_causal=causal), calls)
        plain_ms = device_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), max(2, calls // 4))
        ms_again = device_ms(kern, calls)
        size = q.element_size()
        b_ms, b_by = flash_bound(b, h, sq, d, size, causal, sk)
        pipes, nbytes = cost.pipes("flash_attention", b=b, h=h, s=sq, d=d,
                                   itemsize=size, causal=causal, sk=sk)
        flops = sum(pipes.values())
        tf3 = max(nbytes / roofline.HBM_BW, 3 * flops / roofline.TF32_FLOPS)
        splits = ops.flash_simt_splits(b, h, sq, sk)
        tf3_txt = f" 3xTF32 bound={tf3 * 1e6:.2f}us" if size == 4 else ""
        print(f"  time flash_attention (SIMT) {label} [{b},{h},{sq},{d}] "
              f"Sk={sk} {str(dtype)[6:]} causal={causal:d} splits={splits} "
              f"kernel={ms * 1e3:.2f}us (again {ms_again * 1e3:.2f}us, "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s) plain="
              f"{plain_ms * 1e3:.2f}us library(sdpa)={lib_ms * 1e3:.2f}us "
              f"bound={b_ms * 1e3:.2f}us ({b_by}){tf3_txt} "
              f"kernel/sdpa={ms / lib_ms:.3f}", flush=True)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by}
    return out


def route_slots_bound(t, e, k, cap, itemsize):
    """``launch.roofline.route_slots_bound`` (the kernel costs' one
    source)."""
    from repro_torch.launch import roofline
    return roofline.route_slots_bound(t, e, k, cap, itemsize)


def replaced_route(x, k, cap):
    """What ``moe_grouped`` ran before the fused kernel, up to the slots:
    the router kernel, then the rank by a ``cumsum`` over the [T*k, E]
    int64 one-hot along its outer axis, its gather and the capacity."""
    from repro_torch.kernels import ops
    gates, idx = ops.moe_router_topk(x, k)
    flat = idx.reshape(-1).long()
    rank = torch.cumsum(torch.nn.functional.one_hot(flat, x.shape[1]),
                        dim=0) - 1
    rank = rank.gather(1, flat[:, None])[:, 0]
    return gates, idx, torch.where(rank < cap, rank,
                                   torch.full_like(rank, cap))


def time_route_slots(dev):
    """The fused route-and-slot kernel (timed first and last), its plain
    version and the route it replaced (``replaced_route``) at T = 2048
    (prefill B=4 x S=512), 4096, 4 and 32768 (expert parallelism's
    all_to_all path a data shard at prefill_32k), E = 64, k = 6, and at
    T = 4096, E = 16, k = 2 (Jamba), f32 logits, ``moe_grouped``'s
    capacity. Returns the row of the first shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import grouped_capacity
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {}
    for t, e, k in ((2048, 64, 6), (4096, 64, 6), (4, 64, 6), (4096, 16, 2),
                    (32768, 64, 6)):
        x = torch.randn(t, e, generator=gen, device=dev)
        cap = grouped_capacity(t, e, k)
        ms = device_ms(lambda: ops.moe_route_slots(x, k, cap))
        calls = 10 if t <= 4096 else 2
        plain_ms = device_ms(lambda: ref.moe_route_slots_ref(x, k, cap),
                             calls)
        old_ms = device_ms(lambda: replaced_route(x, k, cap), calls)
        ms_again = device_ms(lambda: ops.moe_route_slots(x, k, cap))
        b_ms, b_by = route_slots_bound(t, e, k, cap, 4)
        print(f"  time moe_route_slots T={t:5d} E={e:2d} k={k} cap={cap} f32 "
              f"kernel={ms * 1e3:.2f}us (again {ms_again * 1e3:.2f}us) "
              f"plain={plain_ms * 1e3:.2f}us replaced route (router + "
              f"one-hot cumsum)={old_ms * 1e3:.2f}us library=- "
              f"bound={b_ms * 1e3:.3f}us ({b_by})")
        out.setdefault("moe_route_slots", {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by})
    return out


def ssd_inputs(gen, b, s, h, n, p, chunk, dev):
    """ssd_chunk's arguments as ``models.ssm.ssd_scan`` hands them to the
    kernel (``ssm.ssd_chunk_inputs``: x a [G, H, T, P] view of the
    [G, T, H, P] chunks), from the model's decay range: A_log = log(1..H),
    so A reaches -H, and dt = softplus of a unit normal (dt_bias 0), so
    acum falls by up to ~33 a step on the last head at H = 48."""
    from repro_torch.models import ssm
    x = torch.randn(b, s, h, p, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen,
                                                  device=dev))
    A = torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev))
    B = torch.randn(b, s, n, generator=gen, device=dev)
    C = torch.randn(b, s, n, generator=gen, device=dev)
    args, _ = ssm.ssd_chunk_inputs(x, dt, A, B, C, chunk)
    return args


def ssd_bound(g, h, t, n, p):
    """``launch.roofline.ssd_bound`` (the kernel costs' one source)."""
    from repro_torch.launch import roofline
    return roofline.ssd_bound(g, h, t, n, p)


# (tag, batch, seq, heads, d_state, head_dim, chunk); G = batch * seq / chunk
SSD_MAIN = ("mamba2-780m B=4 S=2048", 4, 2048, 48, 128, 64, 256)
SSD_CASES = (SSD_MAIN,
             ("mamba2-780m B=1 S=16384", 1, 16384, 48, 128, 64, 256),
             ("ragged T=200", 2, 200, 48, 128, 64, 200),
             ("jamba", 1, 1024, 128, 16, 64, 256),
             ("reduced", 2, 64, 16, 16, 32, 32),
             ("H=12 P=16 N=32 T=100", 2, 100, 12, 32, 16, 100),
             # Mamba2-780M's inner width (3,072) in heads of 16: synthetic,
             # no model runs P = 16
             ("P=16 d_inner=3072 B=4 S=2048", 4, 2048, 192, 128, 16, 256),
             # a model shard's heads under tensor parallelism: [10]'s
             # Mamba2 prefill_32k at tp 4, [11]'s reduced mamba2 at tp 4
             # and 2; then Mamba2 at tp 2 and Jamba at tp 4, which no
             # phase runs (extra coverage)
             ("mamba2-780m shard tp=4", 1, 32768, 12, 128, 64, 256),
             ("reduced shard tp=4", 2, 32, 4, 16, 32, 32),
             ("reduced shard tp=2", 2, 32, 8, 16, 32, 32),
             ("mamba2-780m shard tp=2 (extra)", 4, 2048, 24, 128, 64, 256),
             ("jamba shard tp=4 (extra)", 1, 1024, 32, 16, 64, 256))
# the timed shapes: Mamba2-780M's two prefill shapes, Jamba's at S = 4096,
# and the two P = 16 shapes of SSD_CASES
SSD_TIMED = (SSD_MAIN, SSD_CASES[1],
             ("jamba B=1 S=4096", 1, 4096, 128, 16, 64, 256),
             SSD_CASES[5], SSD_CASES[6])


def check_ssd(dev):
    """ssd_chunk against its plain version at the main path's shapes and
    layout (Mamba2-780M at B=4/S=2048 and B=1/S=16384), a ragged T = 200,
    the Jamba shape, a reduced shape, P = 16 (a last head group of 4 at
    H = 12, and Mamba2-780M's inner width in heads of 16), all in the main
    path's layout, plus the main shape with x contiguous. Each case runs
    through ``ops.ssd_chunk``, which must launch ``ssd_chunk_tc`` once.
    Limit: 1e-5 * max|y| of the call (3xTF32, ~2^-21 relative per
    product; the exponent of the fp32 difference). Returns the worst max
    |error|."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst = {"ssd_chunk_tc": 0.0}
    worst_ratio = 0.0
    for tag, b, s, h, n, p, chunk in SSD_CASES + (
            ("main contiguous x",) + SSD_MAIN[1:],):
        args = ssd_inputs(gen, b, s, h, n, p, chunk, dev)
        if tag == "main contiguous x":
            args = args[:4] + (args[4].contiguous(),)
        err, ratio = ssd_case(tag, args)
        worst["ssd_chunk_tc"] = max(worst["ssd_chunk_tc"], err)
        worst_ratio = max(worst_ratio, ratio)
    print(f"  ssd worst err/limit {worst_ratio:.3f}")
    return worst


def ssd_case(tag, args):
    """One ssd_chunk call through ``ops`` (one launch of ``ssd_chunk_tc``)
    against the plain version within 1e-5 * max|y|. Returns (max |error|,
    error/limit)."""
    from repro_torch.kernels import ops, ref
    g, h, t, p = args[4].shape
    n = args[0].shape[-1]
    before = ops.LAUNCHES["ssd_chunk_tc"]
    got = ops.ssd_chunk(*args)
    launched = ops.LAUNCHES["ssd_chunk_tc"] - before
    want = ref.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    if launched != 1:
        fail(f"ssd_chunk {tag}: {launched} ssd_chunk_tc launches, "
             f"expected one")
    lim = 1e-5 * float(want.abs().max())
    err = float((got - want).abs().max())
    print(f"  check ssd_chunk_tc {tag:28s} [G,H,T,N,P]={[g, h, t, n, p]} "
          f"max|y|={float(want.abs().max()):.3e} max_abs_err={err:.3e} "
          f"err/limit={err / lim:.3f} min(acum)={float(args[2].min()):.1f}")
    if got.shape != want.shape or got.dtype != torch.float32 \
            or not bool(torch.isfinite(got).all()) or not err <= lim:
        fail(f"ssd_chunk_tc {tag} disagrees with its plain version")
    CHECKED.add(ssd_key(args))
    return err, err / lim


def time_ssd(dev):
    """ssd_chunk_tc (through ``ops``, timed first and last) and the plain
    version, with the bound, at ``SSD_TIMED``'s shapes in the main path's
    layout; no single PyTorch call computes this function. Returns the
    row of the main shape."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    out = {}
    for tag, b, s, h, n, p, chunk in SSD_TIMED:
        args = ssd_inputs(gen, b, s, h, n, p, chunk, dev)
        g, t = args[4].shape[0], args[4].shape[2]
        ms = device_ms(lambda: ops.ssd_chunk(*args), 20)
        plain_ms = device_ms(lambda: ref.ssd_chunk_ref(*args), 5)
        ms_again = device_ms(lambda: ops.ssd_chunk(*args), 20)
        b_ms, b_by, cc_ms = ssd_bound(g, h, t, n, p)
        print(f"  time ssd_chunk_tc [{g},{h},{t},{n},{p}] f32 main-path "
              f"layout ({tag}) kernel={ms * 1e3:.2f}us (again "
              f"{ms_again * 1e3:.2f}us) plain={plain_ms * 1e3:.2f}us "
              f"library=- bound={b_ms * 1e3:.2f}us ({b_by}; fp32 CUDA-core "
              f"figure {cc_ms * 1e3:.2f}us) tc/bound={ms / b_ms:.2f}")
        out.setdefault("ssd_chunk_tc", {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by})
    return out


# ---------------------------------------------------------------------------
# Phase 4: DeFTA end to end
# ---------------------------------------------------------------------------

class MovedDraws:
    """CPU-generated draws handed to a run on any device, so a card run and
    a CPU run consume the same random numbers. ``provider`` is one of
    ``repro_torch.rng``'s default providers (``TorchDraws`` by default);
    its result, a tensor or a dataclass of tensors and dicts of them, is
    moved whole."""

    def __init__(self, seed, dev, provider=None):
        from repro_torch.rng import TorchDraws
        gen = torch.Generator()
        gen.manual_seed(seed)
        self.inner, self.dev = (provider or TorchDraws)(gen), dev

    def move(self, v):
        if isinstance(v, dict):
            return {k: self.move(x) for k, x in v.items()}
        return v.to(self.dev) if isinstance(v, torch.Tensor) else v

    def __call__(self, *args, **kw):
        d = self.inner(*args, **kw)
        if isinstance(d, torch.Tensor):
            return d.to(self.dev)
        for f in dataclasses.fields(d):
            setattr(d, f.name, self.move(getattr(d, f.name)))
        return d


def states_agree(a: dict, b: dict, wire: str) -> bool:
    """A card run's DeFTA state fields against the CPU run's: fp32 at
    rtol 1e-3 (summation order; SGD's drift over 4 rounds), params
    included; int8 at rtol 2e-2 (a flipped round-half tie moves a loss
    further), losses and conf only."""
    rtol = 1e-3 if wire == "float32" else 2e-2
    ok = np.allclose(a["last_loss"], b["last_loss"], rtol=rtol) \
        and np.allclose(a["conf"], b["conf"], rtol=rtol, atol=1e-4)
    if wire == "float32":
        ok = ok and all(np.allclose(a["params"][k], b["params"][k],
                                    rtol=rtol, atol=1e-4)
                        for k in a["params"])
    return ok


def card_vs_cpu():
    """A small world run on the card (kernels) and on the CPU (plain
    versions) from one initial state and one draw stream."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import init_state
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    data = federated_dataset("vector", 12, np.random.default_rng(1),
                             n_per_worker=48)
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    for wire, backend, kernel in (("float32", "auto", "gossip_mix_sparse"),
                                  ("int8", "auto", "gossip_mix_quant"),
                                  ("float32", "pallas", "gossip_mix")):
        cfg = DeFTAConfig(num_workers=12, avg_peers=2, num_sampled=1,
                          local_epochs=2, gossip_dtype=wire)
        gen = torch.Generator()
        gen.manual_seed(0)
        init = state_to_numpy(init_state(gen, task, 13,
                                         wire_error=wire == "int8"))
        res = {}
        for dev in ("cuda", "cpu"):
            st, *_ = run_defta(0, task, cfg, train, data, epochs=4,
                               num_malicious=1, gossip_backend=backend,
                               device=dev, init=state_from_jax(init, dev),
                               draws=MovedDraws(5, dev))
            res[dev] = state_to_numpy(st)
        a, b = res["cuda"], res["cpu"]
        loss_err = float(np.abs(a["last_loss"] - b["last_loss"]).max())
        ok = states_agree(a, b, wire)
        print(f"  card-vs-cpu {kernel:18s} wire={wire:7s} "
              f"max|last_loss diff|={loss_err:.3e} agree={ok}")
        if not ok:
            fail(f"card run of {kernel} disagrees with the CPU run")
    card_vs_cpu_fedavg(data, task, train)
    card_vs_cpu_async(data, task, train)


def card_vs_cpu_fedavg(data, task, train):
    """FedAdam on a CFL-S cohort of 2 with one attacker, 4 epochs, on the
    card and on the CPU from one server and one draw stream."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.convert import (fedavg_state_from_jax,
                                     fedavg_state_to_numpy)
    from repro_torch.core.fedavg import init_state, run_fedavg
    from repro_torch.rng import TorchFedAvgDraws
    cfg = DeFTAConfig(num_workers=12, local_epochs=2)
    gen = torch.Generator()
    gen.manual_seed(0)
    init = fedavg_state_to_numpy(init_state(gen, task, "fedadam"))
    res = {}
    for dev in ("cuda", "cpu"):
        st, _ = run_fedavg(0, task, cfg, train, data, epochs=4,
                           num_malicious=1, sample_workers=2,
                           server_opt="fedadam", device=dev,
                           init=fedavg_state_from_jax(init, dev),
                           draws=MovedDraws(5, dev, TorchFedAvgDraws))
        res[dev] = fedavg_state_to_numpy(st)
    a, b = res["cuda"], res["cpu"]
    trees = [(a["server"], b["server"]), (a["opt"]["m"], b["opt"]["m"]),
             (a["opt"]["v"], b["opt"]["v"])]
    err = max(float(np.abs(x[k] - y[k]).max()) for x, y in trees for k in x)
    ok = all(np.allclose(x[k], y[k], rtol=1e-3, atol=1e-4)
             for x, y in trees for k in x)
    print(f"  card-vs-cpu fedavg (fedadam, cfl-s 2, 1 attacker) "
          f"max|server, m, v diff|={err:.3e} agree={ok}")
    if not ok:
        fail("card run of FedAdam disagrees with the CPU run")


def card_vs_cpu_async(data, task, train):
    """AsyncDeFTA on each gossip kernel, 6 ticks, on the card and on the
    CPU from one initial state, one round draw stream and one tick draw
    stream: the same workers fire, so the epoch counters must be equal."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.engine import init_state
    from repro_torch.rng import TorchTickDraws
    for wire, backend, kernel in (("float32", "auto", "gossip_mix_sparse"),
                                  ("int8", "auto", "gossip_mix_quant"),
                                  ("float32", "pallas", "gossip_mix")):
        cfg = DeFTAConfig(num_workers=12, avg_peers=2, num_sampled=1,
                          local_epochs=2, gossip_dtype=wire)
        gen = torch.Generator()
        gen.manual_seed(0)
        init = state_to_numpy(init_state(gen, task, 13,
                                         wire_error=wire == "int8"))
        res = {}
        for dev in ("cuda", "cpu"):
            st, *_ = run_async_defta(
                0, task, cfg, train, data, ticks=6, num_malicious=1,
                gossip_backend=backend, device=dev,
                init=state_from_jax(init, dev), draws=MovedDraws(5, dev),
                tick_draws=MovedDraws(6, dev, TorchTickDraws))
            res[dev] = state_to_numpy(st)
        a, b = res["cuda"], res["cpu"]
        loss_err = float(np.abs(a["last_loss"] - b["last_loss"]).max())
        same_epochs = np.array_equal(a["epoch"], b["epoch"])
        ok = same_epochs and states_agree(a, b, wire)
        print(f"  card-vs-cpu async {kernel:18s} wire={wire:7s} "
              f"epochs={a['epoch'].tolist()} "
              f"max|last_loss diff|={loss_err:.3e} agree={ok}")
        if not ok:
            fail(f"async card run of {kernel} disagrees with the CPU run "
                 f"(epochs equal: {same_epochs})")


def table2_world(kind="vector", wire="float32"):
    """The Table 2 world (``benchmarks/common.make_setup``: 20 vanilla
    workers, MLP on vectors or CNN on images; the runs append 2 noise
    attackers)."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.tasks import cnn_task, mlp_task
    from repro_torch.data import federated_dataset
    rng = np.random.default_rng(0)
    if kind == "image":
        data = federated_dataset("image", 20, rng, hw=10, n_per_worker=100)
        task = cnn_task(10, 1, 10, width=8)
    else:
        data = federated_dataset("vector", 20, rng, n_per_worker=150)
        task = mlp_task(32, 10)
    cfg = DeFTAConfig(num_workers=20, avg_peers=4, num_sampled=2,
                      local_epochs=5, seed=0, gossip_dtype=wire)
    return data, task, cfg, TrainConfig(learning_rate=0.05, batch_size=32)


def end_to_end():
    from repro_torch.core.defta import run_defta
    from repro_torch.kernels import ops
    from repro_torch.telemetry import RunLedger

    epochs = 20
    runs = (
        ("mlp fp32 auto", "vector", "float32", "auto", "gossip_mix_sparse"),
        ("mlp int8+ef auto", "vector", "int8", "auto", "gossip_mix_quant"),
        ("mlp fp32 pallas", "vector", "float32", "pallas", "gossip_mix"),
        ("cnn fp32 auto", "image", "float32", "auto", "gossip_mix_sparse"),
    )
    launches = {}
    for label, kind, wire, backend, kernel in runs:
        data, task, cfg, train = table2_world(kind, wire)
        led = RunLedger()
        ops.reset_launches()
        t0 = time.perf_counter()
        st, _, _, hist = run_defta(0, task, cfg, train, data, epochs=epochs,
                                   num_malicious=2, gossip_backend=backend,
                                   eval_every=5, test_x=data["test_x"],
                                   test_y=data["test_y"], ledger=led,
                                   probes=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        leaves = len(st.params)
        acc = hist[-1][1]
        per_epoch = [1e3 * s / 5 for s in led.superstep_s]  # 5-epoch chunks
        print(f"  e2e {label:17s} epochs={epochs} wall={wall:.2f}s "
              f"per_epoch_ms={[round(x, 2) for x in per_epoch]} "
              f"vanilla_acc={[round(h[1], 4) for h in hist]} "
              f"launches={counts}")
        if not bool(torch.isfinite(st.last_loss).all()):
            fail(f"{label}: non-finite loss")
        want = {k: leaves * epochs if k == kernel else 0 for k in counts}
        if counts != want:
            fail(f"{label}: launch counts {counts}, expected {want}")
        if label == "mlp fp32 auto" and not acc > 0.3:
            fail(f"{label}: vanilla accuracy {acc} <= 0.3")
        launches.setdefault(kernel, counts[kernel])
    return launches


def fedavg_end_to_end():
    """CFL-F, CFL-S and FedAdam on the card, 20 epochs each: no kernel may
    launch (FedAvg's aggregate is a plain product, as in the reference)."""
    from repro_torch.core.fedavg import run_fedavg
    from repro_torch.kernels import ops
    from repro_torch.telemetry import RunLedger

    epochs = 20
    data, task, cfg, train = table2_world()
    for label, kw in (("cfl-f", {}), ("cfl-s", {"sample_workers": 2}),
                      ("fedadam", {"server_opt": "fedadam"})):
        led = RunLedger()
        ops.reset_launches()
        st, hist = run_fedavg(0, task, cfg, train, data, epochs=epochs,
                              num_malicious=2, eval_every=5,
                              test_x=data["test_x"], test_y=data["test_y"],
                              ledger=led, probes=False, **kw)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        dev = st.server["w1"].device
        x = torch.as_tensor(data["test_x"]).to(dev)[None]
        y = torch.as_tensor(data["test_y"]).to(dev)[None]
        with torch.no_grad():
            loss = float(task.loss({k: v[None] for k, v in
                                    st.server.items()}, x, y,
                                   torch.ones(1, x.shape[1], device=dev))[0])
        per_epoch = [1e3 * s / 5 for s in led.superstep_s]  # 5-epoch chunks
        print(f"  fedavg {label:8s} epochs={epochs} per_epoch_ms="
              f"{[round(v, 2) for v in per_epoch]} server_acc="
              f"{[round(h[1], 4) for h in hist]} server_test_loss="
              f"{loss:.4f} launches={counts}")
        if any(counts.values()):
            fail(f"fedavg {label}: launch counts {counts}, expected none")
        if not np.isfinite(loss):
            fail(f"fedavg {label}: non-finite server loss {loss}")
    # the attackers' noise (scale 200) drags the undefended server down
    # (paper Table 3), so accuracy is checked without them
    led = RunLedger()
    st, hist = run_fedavg(0, task, cfg, train, data, epochs=epochs,
                          eval_every=epochs, test_x=data["test_x"],
                          test_y=data["test_y"], ledger=led, probes=False)
    print(f"  fedavg cfl-f, no attacker: per_epoch_ms="
          f"{1e3 * led.wall_s / epochs:.2f} server_acc={hist[-1][1]:.4f}")
    if not hist[-1][1] > 0.3:
        fail(f"fedavg cfl-f: server accuracy {hist[-1][1]} <= 0.3")


def async_end_to_end(launches):
    """AsyncDeFTA on the card: 20 ticks on each gossip wire, then one
    targeted run that stops early. Each run must launch its wire's kernel
    exactly leaves x ticks run times (the round runs on every tick, fired
    or not) and no other kernel; the async launches are added to
    ``launches``."""
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import evaluate
    from repro_torch.kernels import ops
    from repro_torch.telemetry import RunLedger

    runs = (("fp32 auto", "float32", "auto", "gossip_mix_sparse", {}),
            ("int8+ef auto", "int8", "auto", "gossip_mix_quant", {}),
            ("fp32 pallas", "float32", "pallas", "gossip_mix", {}),
            ("fp32 auto target 3", "float32", "auto", "gossip_mix_sparse",
             {"ticks": 40, "target_epochs": 3, "check_every": 4}))
    for label, wire, backend, kernel, kw in runs:
        data, task, cfg, train = table2_world("vector", wire)
        kw = {"ticks": 20, **kw}
        led = RunLedger()
        ops.reset_launches()
        st, _, mal, _ = run_async_defta(0, task, cfg, train, data,
                                        num_malicious=2,
                                        gossip_backend=backend, ledger=led,
                                        probes=False, **kw)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        ran = led.rounds_done
        leaves = len(st.params)
        eps = st.epoch.cpu().numpy()[~mal]
        acc, _, _ = evaluate(task, st, data["test_x"], data["test_y"], mal)
        print(f"  async {label:18s} ticks_run={ran}/{kw['ticks']} "
              f"per_tick_ms={1e3 * led.wall_s / ran:.2f} "
              f"epochs={eps.min()}-{eps.max()} vanilla_acc={acc:.4f} "
              f"launches={counts}")
        want = {k: leaves * ran if k == kernel else 0 for k in counts}
        if counts != want:
            fail(f"async {label}: launch counts {counts}, expected {want}")
        if not eps.max() > eps.min():
            fail(f"async {label}: no spread in worker epochs {eps}")
        if not bool(torch.isfinite(st.last_loss).all()):
            fail(f"async {label}: non-finite loss")
        if "target_epochs" in kw and not (
                ran < kw["ticks"] and (eps >= kw["target_epochs"]).all()):
            fail(f"async {label}: ran {ran} ticks, epochs {eps}: expected "
                 f"an early exit at the target")
        launches[kernel] += counts[kernel]


# ---------------------------------------------------------------------------
# Phase 4s: scenarios end to end
# ---------------------------------------------------------------------------

# vanilla accuracy after 20 epochs of the Table 3 world under
# paper_noise@40 must pass this guard; the reference reaches 0.629 in that
# world (benchmarks/table3_robustness.py, run(epochs=20, ks=(40,)), its
# k = 40 row, JAX on the CPU)
TABLE3_ACC_GUARD = 0.3


def run_counted(label, kernel, runs, fn, want_regime=None):
    """Run ``fn()`` (a run_defta or run_async_defta call returning its state
    first and a ledger last) with the counters at 0; check that ``kernel``
    (None: no kernel) launched leaves x ``runs(out)`` times and nothing
    else, and, with ``want_regime``, only in that regime. Returns (out,
    counts)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts, regimes = dict(ops.LAUNCHES), dict(ops.REGIMES)
    st, led = out[0], out[-1]
    n = len(st.params) * runs(led)
    want = {k: n if k == kernel else 0 for k in counts}
    if counts != want:
        fail(f"{label}: launch counts {counts}, expected {want}")
    if want_regime is not None and regimes != {want_regime: n}:
        fail(f"{label}: regimes {regimes}, expected {{{want_regime}: {n}}}")
    if not bool(torch.isfinite(st.last_loss).all()):
        fail(f"{label}: non-finite loss")
    return out, counts


def scenario_end_to_end(launches):
    """Phase 4s on the card; the phase's launches are added to
    ``launches``."""
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import evaluate, run_defta
    from repro_torch.core.gossip import SPARSE_DENSITY_THRESHOLD
    from repro_torch.scenarios import (AttackSpec, ScenarioSpec,
                                       TopologySpec, compile_scenario)
    from repro_torch.telemetry import RunLedger

    data, task, cfg, train = table2_world()
    tx, ty = data["test_x"], data["test_y"]

    def defta(label, kernel, epochs, regime=None, c=cfg, **kw):
        def go():
            led = RunLedger()
            st, _, mal, hist = run_defta(0, task, c, train, data,
                                         epochs=epochs, eval_every=epochs,
                                         test_x=tx, test_y=ty, ledger=led,
                                         probes=False, **kw)
            return st, mal, hist, led
        (st, mal, hist, led), counts = run_counted(
            label, kernel, lambda led: led.rounds_done, go, regime)
        ms = 1e3 * led.wall_s / epochs
        print(f"  4s {label:28s} W={st.conf.shape[0]} epochs={epochs} "
              f"per_epoch_ms={ms:.2f} vanilla_acc={hist[-1][1]:.4f} "
              f"launches={ {k: v for k, v in counts.items() if v} }",
              flush=True)
        for k, v in counts.items():
            if v:
                launches[k] += v
        return st, hist[-1][1], ms

    # the Table 3 world, scenario and legacy paths, on auto
    for label, kw in (("table3 paper_noise@40 auto",
                       {"scenario": "paper_noise@40"}),
                      ("table3 num_malicious=40 auto",
                       {"num_malicious": 40})):
        _, acc, _ = defta(label, "gossip_mix_sparse", 20,
                          "gossip_mix_sparse/slices", **kw)
        if not acc > TABLE3_ACC_GUARD:
            fail(f"{label}: vanilla accuracy {acc} <= {TABLE3_ACC_GUARD}")
    # W = 60 > GOSSIP_STREAM_MAX_W: the dense mix's tile regime
    defta("table3 paper_noise@40 pallas", "gossip_mix", 10,
          "gossip_mix/tile", scenario="paper_noise@40",
          gossip_backend="pallas")
    # storm on the three wires
    stoch = dataclasses.replace(cfg, gossip_dtype="int8",
                                gossip_wire_round="stochastic")
    for label, kernel, c, be in (
            ("storm fp32 auto", "gossip_mix_sparse", cfg, "auto"),
            ("storm int8+ef stochastic auto", "gossip_mix_quant", stoch,
             "auto"),
            ("storm fp32 pallas", "gossip_mix", cfg, "pallas")):
        st, _, _ = defta(label, kernel, 12, c=c, scenario="storm",
                         gossip_backend=be)
        eps = st.epoch.cpu().numpy()
        if not eps.min() < 12 == eps.max():
            fail(f"{label}: epochs {eps}: the churned worker and the "
                 f"straggler must fall behind")
    # time-varying topologies at W = 60: auto picks by the union's density
    # (two segments stay sparse, five go dense)
    for every in (5, 2):
        spec = ScenarioSpec(attacks=tuple(AttackSpec("noise")
                                          for _ in range(40)),
                            topology=TopologySpec("random_kout", 4,
                                                  every=every))
        sc = compile_scenario(spec, 20, 10)
        union = sc.adj_union | np.eye(sc.num_workers, dtype=bool)
        density = float(union.mean())
        pick, regime = ("gossip_mix_sparse", "slices") \
            if density <= SPARSE_DENSITY_THRESHOLD else ("gossip_mix", "tile")
        print(f"  4s topology every={every}: {sc.num_segments} segments, "
              f"union density {density:.4f} -> auto picks {pick}")
        defta(f"topology every={every} auto", pick, 10,
              f"{pick}/{regime}", scenario=sc)
    # the robust rules: no mix launches
    for rule in ("trimmed_mean", "median", "krum"):
        c = dataclasses.replace(cfg, aggregation=rule, use_dts=False,
                                time_machine=False)
        defta(f"robust {rule}", None, 10, c=c, scenario="paper_noise@40")
    # AsyncDeFTA under storm, with a target that stops it early

    def go():
        led = RunLedger()
        st, _, mal, _ = run_async_defta(0, task, cfg, train, data, ticks=40,
                                        target_epochs=4, check_every=4,
                                        scenario="storm", ledger=led,
                                        probes=False)
        return st, mal, led
    (st, mal, led), counts = run_counted(
        "async storm target 4", "gossip_mix_sparse",
        lambda led: led.rounds_done, go)
    ran = led.rounds_done
    eps = st.epoch.cpu().numpy()[~mal]
    acc, _, _ = evaluate(task, st, tx, ty, mal)
    print(f"  4s async storm target 4       ticks_run={ran}/40 per_tick_ms="
          f"{1e3 * led.wall_s / ran:.2f} epochs={eps.tolist()} "
          f"vanilla_acc={acc:.4f} launches="
          f"{ {k: v for k, v in counts.items() if v} }")
    if not ran < 40:
        fail(f"async storm: ran {ran} ticks, expected an early exit")
    launches["gossip_mix_sparse"] += counts["gossip_mix_sparse"]
    scenario_card_vs_cpu()


def scenario_card_vs_cpu():
    """A reduced storm world (10 vanilla workers, W = 13) on each gossip
    kernel, a krum world (3 noise attackers), and the Table 3 world
    (paper_noise@40, W = 60) on ``pallas``, whose card run must launch the
    dense mix's tile regime only, on the card and on the CPU from one
    initial state and one draw stream."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import init_state
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    from repro_torch.kernels import ops
    from repro_torch.scenarios import robust_agg
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=16)
    # (scenario, vanilla workers, kernel, config change, backend)
    worlds = (
        ("storm", 10, "gossip_mix_sparse", dict(), "auto"),
        ("storm", 10, "gossip_mix_quant",
         dict(gossip_dtype="int8", gossip_wire_round="stochastic"), "auto"),
        ("storm", 10, "gossip_mix", dict(), "pallas"),
        ("paper_noise@3", 10, "krum", dict(aggregation="krum",
                                           use_dts=False,
                                           time_machine=False), "auto"),
        ("paper_noise@40", 20, "gossip_mix", dict(), "pallas"))
    picks = []
    select = robust_agg.krum_select

    def recording(mask, stacked, trim):
        sel = select(mask, stacked, trim)
        picks[-1].append(sel.cpu().numpy())
        return sel
    robust_agg.krum_select = recording
    try:
        for sc, nv, kernel, change, backend in worlds:
            data = federated_dataset("vector", nv, np.random.default_rng(1),
                                     n_per_worker=48)
            cfg = DeFTAConfig(num_workers=nv, avg_peers=2, num_sampled=1,
                              local_epochs=2, **change)
            w = nv + int(sc.split("@")[1]) if "@" in sc else 13
            gen = torch.Generator()
            gen.manual_seed(0)
            init = state_to_numpy(init_state(
                gen, task, w, wire_error=cfg.gossip_dtype == "int8"))
            res = {}
            for dev in ("cuda", "cpu"):
                picks.append([])
                regimes = dict(ops.REGIMES)
                st, *_ = run_defta(0, task, cfg, train, data, epochs=6,
                                   scenario=sc, gossip_backend=backend,
                                   device=dev, init=state_from_jax(init, dev),
                                   draws=MovedDraws(5, dev))
                res[dev] = state_to_numpy(st)
                if dev == "cuda":
                    ran = {k: v - regimes.get(k, 0)
                           for k, v in ops.REGIMES.items()
                           if v != regimes.get(k, 0)}
            if w > ops.GOSSIP_STREAM_MAX_W and (
                    set(ran) != {"gossip_mix/tile"}):
                fail(f"scenario card run ({sc}, {kernel}, W = {w}): "
                     f"regimes {ran}, expected the dense tile regime only")
            a, b = res["cuda"], res["cpu"]
            wire = "int8" if cfg.gossip_dtype == "int8" else "float32"
            loss_err = float(np.abs(a["last_loss"] - b["last_loss"]).max())
            same_epochs = np.array_equal(a["epoch"], b["epoch"])
            ok = same_epochs and states_agree(a, b, wire)
            if kernel == "krum":
                card_picks, cpu_picks = picks[-2], picks[-1]
                ok = ok and len(card_picks) == 6 and all(
                    np.array_equal(x, y)
                    for x, y in zip(card_picks, cpu_picks))
            print(f"  4s card-vs-cpu {sc:14s} W={w:2d} {kernel:18s} "
                  f"wire={wire:7s} epochs={a['epoch'].tolist()} "
                  f"max|last_loss diff|={loss_err:.3e} agree={ok}")
            if not ok:
                fail(f"scenario card run ({sc}, {kernel}) disagrees with "
                     f"the CPU run (epochs equal: {same_epochs})")
    finally:
        robust_agg.krum_select = select


# ---------------------------------------------------------------------------
# Phase 4t: DTS v2 and v3 trust channels end to end
# ---------------------------------------------------------------------------

TRUST_SIGNALS = ("loss", "geom", "both", "corr", "all")


def filled_slots(sketch) -> np.ndarray:
    """Per worker, the ring-buffer slots that hold a sketch."""
    return (sketch.abs().amax(dim=2) > 0).sum(dim=1).cpu().numpy()


def trust_end_to_end(launches):
    """Phase 4t on the card; the phase's launches are added to
    ``launches``."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import evaluate, run_defta
    from repro_torch.data import federated_dataset
    from repro_torch.scenarios import AttackSpec, ScenarioSpec
    from repro_torch.telemetry import RunLedger

    def defta(label, kernel, regime, epochs, cfg, data, task, train, spec,
              **kw):
        def go():
            led = RunLedger()
            st, adj, mal, hist = run_defta(
                0, task, cfg, train, data, epochs=epochs, scenario=spec,
                eval_every=epochs, test_x=data["test_x"],
                test_y=data["test_y"], ledger=led, probes=False, **kw)
            return st, adj, mal, hist, led
        (st, adj, mal, hist, led), counts = run_counted(
            label, kernel, lambda led: led.rounds_done, go, regime)
        if not bool(torch.isfinite(st.conf).all()):
            fail(f"{label}: non-finite conf")
        corr = cfg.dts_signal in ("corr", "all")
        if corr != (st.sketch is not None):
            fail(f"{label}: sketch {st.sketch is not None}, expected {corr}")
        if corr:
            want = np.minimum(st.epoch.cpu().numpy(), cfg.dts_sketch_rounds)
            if not np.array_equal(filled_slots(st.sketch), want):
                fail(f"{label}: ring-buffer slots filled "
                     f"{filled_slots(st.sketch)}, expected {want}")
        n = sum(counts.values())
        print(f"  4t {label:28s} W={st.conf.shape[0]} epochs={epochs} "
              f"per_epoch_ms={1e3 * led.wall_s / epochs:.2f} "
              f"launches_per_epoch={n / epochs:g} "
              f"vanilla_acc={hist[-1][1]:.4f} attacker_theta="
              f"{theta_share(st, adj, mal):.3f}", flush=True)
        for k, v in counts.items():
            if v:
                launches[k] += v
        return st

    # the trust grid's world (table_trust.py: k = 8 on 20 vanilla workers)
    from repro_torch.config import TrainConfig
    from repro_torch.core.tasks import mlp_task
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    data = federated_dataset("vector", 20, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    for attack in ("alie", "label_flip"):
        spec = ScenarioSpec(attacks=tuple(AttackSpec(attack)
                                          for _ in range(8)))
        for signal in TRUST_SIGNALS:
            cfg = DeFTAConfig(num_workers=20, avg_peers=4, num_sampled=2,
                              local_epochs=3, dts_signal=signal, seed=0)
            defta(f"grid {attack} {signal}", "gossip_mix_sparse",
                  "gossip_mix_sparse/slices", 10, cfg, data, task, train,
                  spec)
    # the Table 3 world at full width under alie colluders (loss beside
    # all, in one call, for the trust stage's cost)
    t3_data, t3_task, t3_cfg, t3_train = table2_world()
    t3_cfg = dataclasses.replace(t3_cfg, dts_signal="all")
    spec = ScenarioSpec(attacks=tuple(AttackSpec("alie") for _ in range(40)))
    for label, kernel, regime, backend, signal in (
            ("table3 alie@40 loss auto", "gossip_mix_sparse",
             "gossip_mix_sparse/slices", "auto", "loss"),
            ("table3 alie@40 all auto", "gossip_mix_sparse",
             "gossip_mix_sparse/slices", "auto", "all"),
            ("table3 alie@40 all pallas", "gossip_mix", "gossip_mix/tile",
             "pallas", "all")):
        defta(label, kernel, regime, 10,
              dataclasses.replace(t3_cfg, dts_signal=signal), t3_data,
              t3_task, t3_train, spec, gossip_backend=backend)

    # async storm: a ring buffer deeper than the run, so a worker's filled
    # slots must equal the rounds it completed

    def go():
        led = RunLedger()
        st, _, mal, _ = run_async_defta(
            0, t3_task, dataclasses.replace(t3_cfg, dts_sketch_rounds=24),
            t3_train, t3_data, ticks=20, scenario="storm", ledger=led,
            probes=False)
        return st, mal, led
    (st, mal, led), counts = run_counted(
        "async storm all", "gossip_mix_sparse", lambda led: led.rounds_done,
        go)
    eps = st.epoch.cpu().numpy()
    filled = filled_slots(st.sketch)
    acc, _, _ = evaluate(t3_task, st, t3_data["test_x"], t3_data["test_y"],
                         mal)
    print(f"  4t async storm all            ticks_run={led.rounds_done}/20 "
          f"per_tick_ms={1e3 * led.wall_s / led.rounds_done:.2f} "
          f"epochs={eps.tolist()} filled={filled.tolist()} "
          f"vanilla_acc={acc:.4f}", flush=True)
    if not np.array_equal(filled, eps) or not eps.min() < eps.max():
        fail(f"async storm all: ring-buffer slots {filled.tolist()} must "
             f"equal the epochs {eps.tolist()}, which must spread")
    launches["gossip_mix_sparse"] += counts["gossip_mix_sparse"]
    trust_card_vs_cpu()
    trust_stage_no_sync()


def trust_stage_no_sync():
    """The trust functions at the Table 3 world's shapes (W = 60, D =
    2,762, R = 8, S = 64) make no host synchronisation (a later CUDA
    graph of the round needs none): one warm call, then one under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.core import dts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    w, d = 60, 2762
    deltas = torch.randn(w, d, device="cuda", generator=gen)
    mask = torch.rand(w, w, device="cuda", generator=gen) < 0.1
    theta = dts.sample_weights(torch.zeros(w, w, device="cuda"), mask)
    hist = torch.zeros(w, 8, 64, device="cuda")
    conf = torch.zeros(w, w, device="cuda")
    damaged = torch.zeros(w, dtype=torch.bool, device="cuda")

    def stage():
        sk = dts.update_sketch(hist, deltas)
        return dts.geom_confidence_update(
            "all", 1.0, conf, mask, theta, conf[0], damaged, deltas, mask,
            theta, sketch=sk, lam_corr=4.0), sk
    stage()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, sk = stage()
    except RuntimeError as e:
        fail(f"the trust stage synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()) or not bool(sk[:, -1].any()):
        fail("the trust stage's check gave a non-finite conf or no sketch")
    print("  4t trust stage (all, W=60, D=2762): no host synchronisation",
          flush=True)


def theta_share(st, adj, malicious) -> float:
    """Mean sampling-weight mass the honest workers place on attackers."""
    from repro_torch.core import dts
    theta = dts.sample_weights(
        st.conf, torch.as_tensor(adj).to(st.conf.device)).cpu().numpy()
    return float(theta[~malicious][:, malicious].sum(axis=1).mean())


class NearZeroBuckets(dict):
    """While active, counts per device type the sketch buckets whose
    count-sketch projection lies within 1e-5 of its row's norm of 0: the
    buckets whose sign a card run and a CPU run may round apart."""

    def __enter__(self):
        from repro_torch.core import dts
        self.update(cuda=0, cpu=0)
        self.dts, self.inner = dts, dts.sketch_deltas

        def recording(deltas, sketch_dim, *, seed=0):
            m = dts._sketch_matrix(seed, deltas.shape[1], sketch_dim,
                                   deltas.device)
            near = (deltas @ m).abs() < 1e-5 * deltas.norm(dim=1,
                                                           keepdim=True)
            self[deltas.device.type] += int(near.sum())
            return self.inner(deltas, sketch_dim, seed=seed)
        dts.sketch_deltas = recording
        return self

    def __exit__(self, *exc):
        self.dts.sketch_deltas = self.inner


def trust_card_vs_cpu():
    """``port_robustness_demo``'s world with ``all``, 6 epochs, on the card
    and on the CPU from one initial state and one draw stream. The CPU
    run's sketch projections are recorded to count the buckets whose sign
    may differ (|projection| < 1e-5 of its row's norm)."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import init_state, sketch_shape
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    from repro_torch.scenarios import (AttackSpec, ScenarioSpec,
                                       StragglerSpec)
    spec = ScenarioSpec(attacks=tuple(AttackSpec("alie") for _ in range(4)),
                        stragglers=(StragglerSpec(worker=5, speed=0.5),))
    data = federated_dataset("vector", 12, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    task = mlp_task(32, 10)
    cfg = DeFTAConfig(num_workers=12, avg_peers=4, num_sampled=2,
                      local_epochs=3, dts_signal="all")
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    gen = torch.Generator()
    gen.manual_seed(0)
    init = state_to_numpy(init_state(gen, task, 16,
                                     sketch=sketch_shape(cfg)))
    res = {}
    with NearZeroBuckets() as near_zero:
        for dev in ("cuda", "cpu"):
            st, *_ = run_defta(0, task, cfg, train, data, epochs=6,
                               scenario=spec, device=dev,
                               init=state_from_jax(init, dev),
                               draws=MovedDraws(5, dev))
            res[dev] = state_to_numpy(st)
    a, b = res["cuda"], res["cpu"]
    errs = {f: float(np.abs(a[f] - b[f]).max())
            for f in ("conf", "last_loss", "best_loss")}
    errs["params"] = max(float(np.abs(a["params"][k] - b["params"][k]).max())
                         for k in a["params"])
    differ = int((a["sketch"] != b["sketch"]).sum())
    same_epochs = np.array_equal(a["epoch"], b["epoch"])
    ok = same_epochs and max(errs["conf"], errs["last_loss"],
                             errs["best_loss"]) <= 1e-4 \
        and differ <= max(near_zero.values())
    print(f"  4t card-vs-cpu demo world all W=16 epochs="
          f"{a['epoch'].tolist()} max|diff| "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" sketch entries differing={differ} (near-zero buckets: card "
          f"{near_zero['cuda']}, cpu {near_zero['cpu']}) agree={ok}",
          flush=True)
    if not ok:
        fail(f"trust card run disagrees with the CPU run (epochs equal: "
             f"{same_epochs}, errors {errs}, sketch entries differing "
             f"{differ})")


# ---------------------------------------------------------------------------
# Phase 4c: cross-device participation end to end
# ---------------------------------------------------------------------------

CD_ROUNDS = 30                 # rounds of each full-width run
CD_LEAVES = 4                  # the MLP's leaves: 4 dense mixes a round


def cross_device_world(data_cache):
    """The reference launcher's ``--cross-device`` default
    (``launch/train.py``): 10,000 enrolled users, k = 64 (availability
    0.7, dropout 0.05, straggle 0.10), 48 examples each (non-iid α = 0.5,
    seed 0), MLP 32 -> 10, 3 local epochs, ``dts_conf_decay`` 0.98,
    ``label_flip`` 0.15 + ``alie`` 0.14 of the enrolled (its attacked
    example). Returns (task, cfg, train, data, spec); the data is made
    once."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    from repro_torch.scenarios import CrossDeviceSpec
    if "data" not in data_cache:
        data_cache["data"] = federated_dataset(
            "vector", 10_000, np.random.default_rng(0), n_per_worker=48,
            alpha=0.5)
    cfg = DeFTAConfig(num_workers=10_000, avg_peers=4, num_sampled=2,
                      local_epochs=3, dts_conf_decay=0.98, seed=0)
    spec = CrossDeviceSpec(attacks=(("label_flip", 0.15), ("alie", 0.14)))
    return (mlp_task(32, 10), cfg,
            TrainConfig(learning_rate=0.05, batch_size=32),
            data_cache["data"], spec)


def fired_rounds(world, rounds):
    """Per enrolled user, the rounds (< ``rounds``) in which it fired."""
    fire = world.filled & world.survive & world.complete
    out = [[] for _ in range(world.enrolled)]
    for t in range(rounds):
        for u in world.part_ix[t][fire[t]]:
            out[u].append(t)
    return out


def cross_device_end_to_end(launches):
    """Phase 4c on the card; the phase's launches are added to
    ``launches``."""
    from repro_torch.core.cross_device import (evaluate_probe,
                                               probe_indices,
                                               run_cross_device)
    from repro_torch.core.engine import init_cross_device_state, sketch_shape
    from repro_torch.core.gossip import uses_error_feedback
    from repro_torch.kernels import ops
    from repro_torch.scenarios import compile_world
    from repro_torch.telemetry import RunLedger

    cache = {}
    task, cfg0, train, data, spec = cross_device_world(cache)
    world = compile_world(spec, CD_ROUNDS)
    fired = fired_rounds(world, CD_ROUNDS)
    never = torch.tensor([u for u, ts in enumerate(fired) if not ts],
                         device="cuda")
    pix = probe_indices(world, 32, seed=0)
    print(f"  4c world {world.summary()}", flush=True)
    for signal, wire in (("loss", "float32"), ("all", "float32"),
                         ("all", "int8")):
        cfg = dataclasses.replace(cfg0, dts_signal=signal, gossip_dtype=wire)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        init = init_cross_device_state(gen, task, world.enrolled,
                                       wire_error=uses_error_feedback(cfg),
                                       sketch=sketch_shape(cfg))
        before = {f.name: getattr(init, f.name)
                  for f in dataclasses.fields(init)}
        absent = {f: ({k: v.index_select(0, never) for k, v in x.items()}
                      if isinstance(x, dict) else x.index_select(0, never))
                  for f, x in before.items() if x is not None}
        acc0, _ = evaluate_probe(task, init, data["test_x"], data["test_y"],
                                 pix)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        led = RunLedger()
        st, hist = run_cross_device(
            0, task, cfg, train, data, world=world, epochs=CD_ROUNDS,
            eval_every=10, test_x=data["test_x"], test_y=data["test_y"],
            ledger=led, probes=False, init=init, draws=None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts, regimes = dict(ops.LAUNCHES), dict(ops.REGIMES)
        label = f"full world {signal} {wire}"
        per_round = [1e3 * x / 10 for x in led.superstep_s]
        print(f"  4c {label:24s} N={world.enrolled} k={world.sample_k} "
              f"rounds={CD_ROUNDS} ms_per_round="
              f"{[round(x, 2) for x in per_round]} peak={peak:.3f}GB "
              f"probe_acc={[round(h[1], 4) for h in hist]} (untrained "
              f"{acc0:.4f}) regimes={regimes}", flush=True)
        n = CD_LEAVES * CD_ROUNDS
        if counts != {k: n if k == "gossip_mix" else 0 for k in counts} or \
                regimes != {"gossip_mix/tile": n}:
            fail(f"{label}: launches {counts}, regimes {regimes}, expected "
                 f"{n} gossip_mix in the tile regime and nothing else")
        if not bool(torch.isfinite(st.conf).all()):
            fail(f"{label}: non-finite conf")
        for f, x in absent.items():
            now = getattr(st, f)
            same = all(torch.equal(now[k].index_select(0, never), v)
                       for k, v in x.items()) if isinstance(x, dict) \
                else torch.equal(now.index_select(0, never), x)
            if not same:
                fail(f"{label}: {f} rows of users who never fired changed")
        if st.sketch_round is not None:
            r = st.sketch_round.shape[1]
            want = np.array([[-1] * (r - len(ts[-r:])) + ts[-r:]
                             for ts in fired], np.int32)
            if not np.array_equal(st.sketch_round.cpu().numpy(), want):
                fail(f"{label}: stamps are not each fired user's rounds "
                     f"in order")
        if not hist[-1][1] > acc0:
            fail(f"{label}: probe accuracy {hist[-1][1]} not above the "
                 f"untrained model's {acc0}")
        launches["gossip_mix"] += counts["gossip_mix"]
        del st, init, before, absent
        torch.cuda.empty_cache()
    cross_device_small_world(launches)
    cross_device_card_vs_cpu(cache)


def cross_device_small_world(launches):
    """The benchmark's attacked world (28 enrolled, k = 14, label_flip
    4/28 + alie 4/28, degree 6, sample 3) under ``all`` for 30 rounds: the
    dense mix's stream regime, 4 launches a round."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.cross_device import run_cross_device
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    from repro_torch.kernels import ops
    from repro_torch.scenarios import CrossDeviceSpec
    from repro_torch.telemetry import RunLedger
    data = federated_dataset("vector", 28, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    cfg = DeFTAConfig(num_workers=28, avg_peers=6, num_sampled=3,
                      local_epochs=3, dts_signal="all", dts_conf_decay=0.98,
                      seed=0)
    spec = CrossDeviceSpec(enrolled=28, sample_k=14, avg_peers=6,
                           attacks=(("label_flip", 4 / 28),
                                    ("alie", 4 / 28)))
    ops.reset_launches()
    led = RunLedger()
    st, hist = run_cross_device(
        0, mlp_task(32, 10), cfg,
        TrainConfig(learning_rate=0.05, batch_size=32), data, world=spec,
        epochs=CD_ROUNDS, eval_every=CD_ROUNDS, test_x=data["test_x"],
        test_y=data["test_y"], ledger=led, probes=False)
    torch.cuda.synchronize()
    counts, regimes = dict(ops.LAUNCHES), dict(ops.REGIMES)
    n = CD_LEAVES * CD_ROUNDS
    print(f"  4c bench world all N=28 k=14 rounds={CD_ROUNDS} "
          f"ms_per_round={1e3 * led.wall_s / CD_ROUNDS:.2f} probe_acc="
          f"{hist[-1][1]:.4f} regimes={regimes}", flush=True)
    if counts != {k: n if k == "gossip_mix" else 0 for k in counts} or \
            regimes != {"gossip_mix/stream": n}:
        fail(f"bench world: launches {counts}, regimes {regimes}, expected "
             f"{n} gossip_mix in the stream regime")
    if not bool(torch.isfinite(st.conf).all()):
        fail("bench world: non-finite conf")
    launches["gossip_mix"] += counts["gossip_mix"]


def field_gap(x, y) -> float:
    """The largest |x - y| of a state field, 0 where both are equal (the
    best loss stays inf for a worker that never improved)."""
    with np.errstate(invalid="ignore"):
        return float(np.where(x == y, 0.0, np.abs(x - y)).max())


def cross_device_card_vs_cpu(cache):
    """The full-width world under ``all`` for 6 rounds on the card (the
    tile regime) and on the CPU from one population and one draw stream:
    conf, params and losses within 1e-4, stamps, epoch, obs and last_part
    exact, sketches equal outside buckets whose projection is within 1e-5
    of its row's norm of 0."""
    from repro_torch.convert import (cross_device_state_from_jax,
                                     cross_device_state_to_numpy)
    from repro_torch.core.cross_device import run_cross_device
    from repro_torch.core.engine import init_cross_device_state, sketch_shape
    from repro_torch.kernels import ops
    task, cfg, train, data, spec = cross_device_world(cache)
    cfg = dataclasses.replace(cfg, dts_signal="all")
    gen = torch.Generator()
    gen.manual_seed(0)
    init = cross_device_state_to_numpy(init_cross_device_state(
        gen, task, 10_000, sketch=sketch_shape(cfg)))
    res = {}
    t0 = time.perf_counter()
    with NearZeroBuckets() as near_zero:
        for dev in ("cuda", "cpu"):
            regimes = dict(ops.REGIMES)
            st, _ = run_cross_device(
                0, task, cfg, train, data, world=spec, epochs=6, device=dev,
                init=cross_device_state_from_jax(init, dev),
                draws=MovedDraws(5, dev))
            res[dev] = cross_device_state_to_numpy(st)
            if dev == "cuda":
                ran = {k: v - regimes.get(k, 0)
                       for k, v in ops.REGIMES.items()
                       if v != regimes.get(k, 0)}
            del st
    a, b = res["cuda"], res["cpu"]
    errs = {f: field_gap(a[f], b[f])
            for f in ("conf", "best_loss", "last_loss")}
    errs["params"] = max(field_gap(a["params"][k], b["params"][k])
                         for k in a["params"])
    close = all(np.allclose(a[f], b[f], rtol=1e-4, atol=1e-4)
                for f in ("conf", "best_loss", "last_loss")) and all(
        np.allclose(a["params"][k], b["params"][k], rtol=1e-4, atol=1e-4)
        for k in a["params"])
    exact = all(np.array_equal(a[f], b[f])
                for f in ("epoch", "obs", "last_part", "sketch_round"))
    differ = int((a["sketch"] != b["sketch"]).sum())
    ok = close and exact and ran == {"gossip_mix/tile": 6 * CD_LEAVES} \
        and differ <= max(near_zero.values())
    print(f"  4c card-vs-cpu full world all N=10000 k=64 rounds=6 "
          f"fired={int(a['epoch'].sum())} card regimes={ran} max|diff| "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" counters and stamps equal={exact} sketch entries differing="
          f"{differ} (near-zero buckets: card {near_zero['cuda']}, cpu "
          f"{near_zero['cpu']}) agree={ok} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    if not ok:
        fail(f"cross-device card run disagrees with the CPU run (errors "
             f"{errs}, counters and stamps equal {exact}, sketch entries "
             f"differing {differ}, regimes {ran})")


# ---------------------------------------------------------------------------
# Phase 4p: the privacy wire end to end
# ---------------------------------------------------------------------------

PRIVACY_EPOCHS = 20            # epochs (ticks) of each Table 2 / async run
PRIVACY_ROUNDS = 20            # rounds of each full-width cross-device run


def mlp_support_world(adj, dev, seed):
    """The MLP's leaves stacked over W = adj's workers, a row-stochastic P
    on the support, and EF21 residuals, from a seeded generator."""
    from repro_torch.core.tasks import mlp_task
    w = adj.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    stacked = mlp_task(32, 10).init(gen, w)
    a = torch.as_tensor(adj | np.eye(w, dtype=bool), device=dev)
    P = torch.rand(w, w, generator=gen, device=dev) * a
    P = P / P.sum(dim=1, keepdim=True)
    residual = {k: 0.01 * torch.randn(v.shape, generator=gen, device=dev)
                for k, v in stacked.items()}
    return stacked, P, residual


def privacy_gossip(dev):
    """The masked mix on the card at the MLP's leaves: the Table 3 world
    (W = 60, the padded-CSR support of its topology) and the cross-device
    cohort (k = 64, all-ones support). On fp32, bf16 and int8 + EF21 the
    masked mix must equal the unmasked K-slot gather-sum of the encoded
    rows bit for bit (int8: so its round-trip error is the unmasked
    quantization error) and the EF21 residuals must equal the unmasked
    encode's; no gossip kernel may launch. The fp32 wire words must
    differ from the plaintext words, and the card's pads must equal the
    CPU's bit for bit. Prints each pad block's words, launches and device
    ms."""
    from repro_torch.core import gossip
    from repro_torch.core import secagg as sa
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import ops
    base = sa.secagg_base_key(0)
    dkey = sa.domain_key(base, sa.DOMAIN_EDGE)
    for label, adj in (("table3 W=60", make_topology("random_kout", 60, 4,
                                                     0)),
                       ("cohort k=64", np.ones((64, 64), bool))):
        w = adj.shape[0]
        stacked, P, residual = mlp_support_world(adj, dev, w)
        idx, val = gossip.sparse_weights(P, adj)
        idx = idx.long()
        ops.reset_launches()
        for wire in (None, "bf16", "int8"):
            res = residual if wire is not None else None
            out = gossip.mix_pytree(P, stacked, "auto", adjacency=adj,
                                    wire=wire, residual=res, secagg=base,
                                    secagg_round=7)
            out, new_r = out if res is not None else (out, None)
            for name, x in stacked.items():
                flat = x.reshape(w, -1)
                if wire is None:
                    pay, scale, nr = flat, None, None
                else:
                    pay, scale, nr = gossip._encode_rows(
                        flat, res[name].reshape(w, -1), wire)
                wts = val * scale[idx] if scale is not None else val
                want = torch.einsum("wk,wkf->wf", wts,
                                    pay[idx].float()).reshape(x.shape)
                if not torch.equal(out[name], want):
                    fail(f"4p {label} wire={wire} {name}: the masked mix "
                         f"differs from the unmasked gather-sum")
                if nr is not None and not torch.equal(
                        new_r[name], nr.reshape(x.shape)):
                    fail(f"4p {label} wire={wire} {name}: EF21 residuals "
                         f"differ from the unmasked encode's")
        torch.cuda.synchronize()
        if any(ops.LAUNCHES.values()):
            fail(f"4p {label}: a gossip kernel launched on a secagg mix "
                 f"({dict(ops.LAUNCHES)})")
        # int8: the masked words decode to the same q and scale
        flat = stacked["w1"].reshape(w, -1)
        q, s = gossip.quantize_rows_int8(flat)
        recv = torch.arange(w, device=dev)[:, None]
        pq, ps = sa.pad_block(dkey, 7, idx, recv,
                              ((0, q.shape[1]), (1, 1)))
        pq, ps = sa.ring_pad(pq, "int8"), sa.ring_pad(ps[..., 0])
        q_g, s_g = q[idx], s[idx]
        q_rec = sa.unmask_payload(sa.mask_payload(q_g, pq, "int8"), pq,
                                  "int8")
        s_rec = sa.unmask_payload(sa.mask_payload(s_g, ps), ps)
        x_g = flat[idx]
        err_masked = (q_rec.float() * s_rec[..., None] - x_g).abs()
        err_plain = (q_g.float() * s_g[..., None] - x_g).abs()
        if not torch.equal(err_masked, err_plain):
            fail(f"4p {label}: int8 masked round-trip error differs from "
                 f"the unmasked quantization error")
        # fp32 wire words against the plaintext, card pads against CPU pads
        channels = tuple((2 * li, v[0].numel())
                         for li, (_, v) in enumerate(sorted(stacked.items())))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        sa.pad_block(dkey, 7, idx, recv, channels)
        torch.cuda.synchronize()
        t0.record()
        card = sa.pad_block(dkey, 7, idx, recv, channels)
        t1.record()
        torch.cuda.synchronize()
        pad_ms = t0.elapsed_time(t1)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            sa.pad_block(dkey, 7, idx, recv, channels)
            torch.cuda.synchronize()
        n_launch = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        cpu = sa.pad_block(dkey, 7, idx.cpu(), recv.cpu(), channels)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
        pay = stacked["w1"].reshape(w, -1)[idx]
        words = sa.mask_payload(pay, card[2])
        frac = float((words == sa.ring_bits(pay)).float().mean())
        n_words = sum(int(p.numel()) for p in card)
        print(f"  4p gossip {label}: masked = unmasked gather-sum bit for "
              f"bit on fp32, bf16, int8 + EF21 (residuals equal, int8 "
              f"round-trip error equal); 0 gossip launches; pad block "
              f"{n_words / 1e6:.3f} M words, {pad_ms:.3f} ms, {n_launch} "
              f"launches; card pads = cpu pads: {same}; fp32 wire words "
              f"equal to plaintext: {frac:.2e}", flush=True)
        if not same:
            fail(f"4p {label}: the card's pads differ from the CPU's")
        if frac > 0.01:
            fail(f"4p {label}: {frac} of the fp32 wire words equal the "
                 f"plaintext")


def privacy_defta_run(label, kernel, fn, launches, base_ms=None):
    """One privacy run through ``run_counted`` (``fn`` returns (state,
    ..., ledger) from runs chunked by ``PRIVACY_EPOCHS // 4``; ``kernel``
    must launch leaves x rounds times in its slice regime, or in the tile
    regime for the dense mix, and nothing else): prints ms an epoch (or
    tick, or round) over the chunks, the launches by regime and the peak
    memory; returns the median ms."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    regime = None if kernel is None else \
        f"{kernel}/{'tile' if kernel == 'gossip_mix' else 'slices'}"
    out, counts = run_counted(label, kernel, lambda led: led.rounds_done, fn,
                              regime)
    peak = torch.cuda.max_memory_allocated() / 1e9
    led = out[-1]
    chunk = led.rounds_done / max(len(led.superstep_s), 1)
    ms = [1e3 * s / chunk for s in led.superstep_s]
    med = statistics.median(ms)
    extra = "" if base_ms is None else \
        f" secagg_extra_ms={med - base_ms:+.2f} ({med / base_ms:.2f}x)"
    print(f"  4p {label:32s} ms={min(ms):.2f}-{max(ms):.2f} "
          f"(median {med:.2f}){extra} regimes={dict(ops.REGIMES)} "
          f"peak={peak:.3f}GB", flush=True)
    for k, v in counts.items():
        if v:
            launches[k] += v
    return out, med


def privacy_end_to_end(launches):
    """Phase 4p on the card; the phase's launches are added to
    ``launches``."""
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import build_defta_round, stage_names
    from repro_torch.core.topology import make_topology
    from repro_torch.scenarios import AttackSpec, ScenarioSpec
    from repro_torch.telemetry import RunLedger

    privacy_gossip(torch.device("cuda"))
    epochs, chunk = PRIVACY_EPOCHS, PRIVACY_EPOCHS // 4

    def defta(cfg, data, task, train, n=epochs, **kw):
        def go():
            led = RunLedger()
            st, adj, mal, _ = run_defta(0, task, cfg, train, data, epochs=n,
                                        eval_every=chunk,
                                        test_x=data["test_x"],
                                        test_y=data["test_y"], ledger=led,
                                        probes=False, **kw)
            return st, adj, mal, led
        return go

    # the Table 2 world: each wire plain, then under secagg (no kernel)
    for wire, kernel in (("float32", "gossip_mix_sparse"),
                         ("bfloat16", "gossip_mix_sparse"),
                         ("int8", "gossip_mix_quant")):
        data, task, cfg, train = table2_world(wire=wire)
        _, plain = privacy_defta_run(
            f"table2 {wire} plain", kernel,
            defta(cfg, data, task, train, num_malicious=2), launches)
        privacy_defta_run(
            f"table2 {wire} secagg", None,
            defta(dataclasses.replace(cfg, secagg="pairwise"), data, task,
                  train, num_malicious=2), launches, base_ms=plain)
    data, task, cfg, train = table2_world()
    adj = make_topology(cfg.topology, 22, cfg.avg_peers, cfg.seed)
    for label, change in (("table2 dp-sgd", dict(dp_clip=1.0,
                                                  dp_sigma=0.5)),
                          ("table2 update dp", dict(dp_sigma=1.0))):
        c = dataclasses.replace(cfg, **change)
        privacy_defta_run(label, "gossip_mix_sparse",
                          defta(c, data, task, train, num_malicious=2),
                          launches)
        names = stage_names(build_defta_round(
            task, c, train, adj, np.full(22, 150), np.zeros(22, bool),
            draws=None, device="cuda"))
        if ("dp_noise" in names) != ("dp_clip" not in change):
            fail(f"{label}: stages {names}")

    # the Table 3 world with 40 alie colluders under all, secagg + update DP
    spec = ScenarioSpec(attacks=tuple(AttackSpec("alie") for _ in range(40)))
    t3 = dataclasses.replace(cfg, dts_signal="all", dp_sigma=1.0,
                             secagg="pairwise")
    for mode in ("edge", "masked_geom"):
        (st, *_), _ = privacy_defta_run(
            f"table3 alie@40 all {mode} + update dp", None,
            defta(dataclasses.replace(t3, secagg_mode=mode), data, task,
                  train, n=10, scenario=spec), launches)
        rotated = bool(st.sketch.abs().sum() > 0)
        if rotated == (mode == "masked_geom"):
            fail(f"table3 {mode}: sketch ring rotated: {rotated}")

    def go_async():
        led = RunLedger()
        st, _, mal, _ = run_async_defta(
            0, task, dataclasses.replace(cfg, secagg="pairwise",
                                         dp_sigma=1.0),
            train, data, ticks=epochs, check_every=chunk, target_epochs=999,
            scenario="storm", ledger=led, probes=False)
        return st, mal, led
    privacy_defta_run("async storm secagg + update dp", None, go_async,
                      launches)
    privacy_cross_device(launches)
    privacy_card_vs_cpu()


def privacy_cross_device(launches):
    """The [4c] world at full width (10,000 enrolled, k = 64) under ``all``
    for ``PRIVACY_ROUNDS`` rounds: plain (4 dense-mix launches a round),
    with secagg ``edge`` + update DP and with ``masked_geom`` + update DP
    (no gossip launch; under ``masked_geom`` the sketches and stamps pass
    through unchanged)."""
    from repro_torch.core.cross_device import run_cross_device
    from repro_torch.core.engine import init_cross_device_state, sketch_shape
    from repro_torch.scenarios import compile_world
    from repro_torch.telemetry import RunLedger

    cache = {}
    task, cfg0, train, data, spec = cross_device_world(cache)
    world = compile_world(spec, PRIVACY_ROUNDS)
    base = None
    for label, change, kernel in (
            ("plain", {}, "gossip_mix"),
            ("secagg edge + update dp", dict(secagg="pairwise",
                                             dp_sigma=1.0), None),
            ("masked_geom + update dp", dict(secagg="pairwise",
                                             secagg_mode="masked_geom",
                                             dp_sigma=1.0), None)):
        cfg = dataclasses.replace(cfg0, dts_signal="all", **change)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        init = init_cross_device_state(gen, task, world.enrolled,
                                       sketch=sketch_shape(cfg))
        sketch0, stamp0 = init.sketch.clone(), init.sketch_round.clone()

        def go():
            led = RunLedger()
            st, _ = run_cross_device(
                0, task, cfg, train, data, world=world,
                epochs=PRIVACY_ROUNDS, eval_every=PRIVACY_ROUNDS // 4,
                test_x=data["test_x"], test_y=data["test_y"], ledger=led,
                probes=False, init=init)
            return st, led
        (st, _), ms = privacy_defta_run(f"cross-device all {label}", kernel,
                                        go, launches, base_ms=base)
        base = ms if base is None else base
        if not bool(torch.isfinite(st.conf).all()):
            fail(f"cross-device {label}: non-finite conf")
        frozen = torch.equal(st.sketch, sketch0) \
            and torch.equal(st.sketch_round, stamp0)
        if frozen != ("secagg_mode" in change):
            fail(f"cross-device {label}: sketches and stamps unchanged: "
                 f"{frozen}")
        del st, init, sketch0, stamp0
        torch.cuda.empty_cache()


def privacy_card_vs_cpu():
    """The Table 2 int8 + EF21 secagg world (4 epochs) and the full-width
    cross-device secagg world (``all``, update DP, 6 rounds) on the card
    and on the CPU from one initial state and one draw stream: every field
    within 1e-4 (the int8 world's models within one quantization step of
    each row), counters, stamps and sketches equal."""
    from repro_torch.convert import (cross_device_state_from_jax,
                                     cross_device_state_to_numpy,
                                     state_from_jax, state_to_numpy)
    from repro_torch.core.cross_device import run_cross_device
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import (init_cross_device_state,
                                         init_state, sketch_shape)

    data, task, cfg, train = table2_world(wire="int8")
    cfg = dataclasses.replace(cfg, secagg="pairwise")
    gen = torch.Generator()
    gen.manual_seed(0)
    init = state_to_numpy(init_state(gen, task, 22, wire_error=True))
    res = {}
    for dev in ("cuda", "cpu"):
        st, *_ = run_defta(0, task, cfg, train, data, epochs=4,
                           num_malicious=2, device=dev,
                           init=state_from_jax(init, dev),
                           draws=MovedDraws(5, dev))
        res[dev] = state_to_numpy(st)
    a, b = res["cuda"], res["cpu"]
    errs = {f: field_gap(a[f], b[f])
            for f in ("conf", "best_loss", "last_loss")}
    # a card-vs-cpu ulp can flip an int8 rounding: phase 4's int8 limits
    # for losses and conf, one quantization step for the models
    steps_ok = True
    for f in ("params", "backup", "wire_err"):
        errs[f] = max(field_gap(a[f][k], b[f][k]) for k in a[f])
        for k, p in b["params"].items():
            rows = p.reshape(p.shape[0], -1)
            step = np.abs(rows).max(axis=1, keepdims=True) / 127.0
            err = np.abs(a[f][k] - b[f][k]).reshape(rows.shape)
            steps_ok = steps_ok and bool((err <= step).all())
    within = all(np.allclose(a[f][k] if isinstance(a[f], dict) else a[f],
                             b[f][k] if isinstance(b[f], dict) else b[f],
                             rtol=1e-4, atol=1e-4)
                 for f in errs for k in (a[f] if isinstance(a[f], dict)
                                         else [None]))
    ok = states_agree(a, b, "int8") and steps_ok \
        and np.array_equal(a["epoch"], b["epoch"])
    print(f"  4p card-vs-cpu table2 int8+ef secagg epochs=4 max|diff| "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" every field within 1e-4={within} models within one "
          f"quantization step={steps_ok} agree={ok}", flush=True)
    if not ok:
        fail(f"4p int8 secagg card run disagrees with the CPU run {errs}")

    cache = {}
    task, cfg, train, data, spec = cross_device_world(cache)
    cfg = dataclasses.replace(cfg, dts_signal="all", secagg="pairwise",
                              dp_sigma=1.0)
    gen = torch.Generator()
    gen.manual_seed(0)
    init = cross_device_state_to_numpy(init_cross_device_state(
        gen, task, 10_000, sketch=sketch_shape(cfg)))
    res = {}
    t0 = time.perf_counter()
    with NearZeroBuckets() as near_zero:
        for dev in ("cuda", "cpu"):
            st, _ = run_cross_device(
                0, task, cfg, train, data, world=spec, epochs=6, device=dev,
                init=cross_device_state_from_jax(init, dev),
                draws=MovedDraws(5, dev))
            res[dev] = cross_device_state_to_numpy(st)
            del st
    a, b = res["cuda"], res["cpu"]
    errs = {f: field_gap(a[f], b[f])
            for f in ("conf", "best_loss", "last_loss")}
    errs["params"] = max(field_gap(a["params"][k], b["params"][k])
                         for k in a["params"])
    close = all(np.allclose(a[f], b[f], rtol=1e-4, atol=1e-4)
                for f in ("conf", "best_loss", "last_loss")) and all(
        np.allclose(a["params"][k], b["params"][k], rtol=1e-4, atol=1e-4)
        for k in a["params"])
    exact = all(np.array_equal(a[f], b[f])
                for f in ("epoch", "obs", "last_part", "sketch_round"))
    differ = int((a["sketch"] != b["sketch"]).sum())
    ok = close and exact and differ <= max(near_zero.values())
    print(f"  4p card-vs-cpu cross-device all secagg + update dp N=10000 "
          f"k=64 rounds=6 fired={int(a['epoch'].sum())} max|diff| "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" counters and stamps equal={exact} sketch entries differing="
          f"{differ} (near-zero buckets: card {near_zero['cuda']}, cpu "
          f"{near_zero['cpu']}) agree={ok} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    if not ok:
        fail(f"4p cross-device secagg card run disagrees with the CPU run "
             f"(errors {errs}, counters and stamps equal {exact}, sketch "
             f"entries differing {differ})")


# ---------------------------------------------------------------------------
# Phase 4m: the telemetry plane and the launcher
# ---------------------------------------------------------------------------

def flat_fields(fields: dict) -> dict:
    """A state's numpy fields flattened to ``{"field" or "field.leaf":
    array}`` (None fields left out)."""
    out = {}
    for f, v in fields.items():
        if isinstance(v, dict):
            out.update({f"{f}.{k}": x for k, x in v.items()})
        elif v is not None:
            out[f] = v
    return out


def state_gap(a: dict, b: dict) -> float:
    """Largest absolute difference between two flattened states (0.0 when
    equal bit for bit; inf when their fields or shapes differ)."""
    fa, fb = flat_fields(a), flat_fields(b)
    if fa.keys() != fb.keys() or any(fa[k].shape != fb[k].shape
                                     for k in fa):
        return float("inf")
    gaps = [0.0 if np.array_equal(fa[k], fb[k], equal_nan=True)
            else float(np.abs(fa[k].astype(np.float64)
                              - fb[k].astype(np.float64)).max())
            for k in fa]
    return max(gaps)


def telemetry_worlds(cache):
    """The [4m] parity and cost worlds, each ``run(on) -> (state fields,
    ledger, units, unit)``: the Table 2 world (MLP fp32 ``auto``, 20
    epochs, eval every 5), the Table 3 world (``paper_noise@40``, W = 60,
    20 epochs, eval every 5), the [4c] full-width cross-device world
    under ``all`` (30 rounds, eval every 10) and async ``storm`` in the
    Table 2 world (20 ticks, a target of 4 epochs checked every 4)."""
    from repro_torch.convert import (cross_device_state_to_numpy,
                                     state_to_numpy)
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.cross_device import run_cross_device
    from repro_torch.core.defta import run_defta
    from repro_torch.scenarios import compile_world
    from repro_torch.telemetry import RunLedger

    data, task, cfg, train = table2_world()
    tx, ty = data["test_x"], data["test_y"]
    cd_task, cd_cfg, cd_train, cd_data, spec = cross_device_world(cache)
    cd_cfg = dataclasses.replace(cd_cfg, dts_signal="all")
    world = compile_world(spec, CD_ROUNDS)

    def table2(on):
        led = RunLedger()
        st, *_ = run_defta(0, task, cfg, train, data, epochs=20,
                           num_malicious=2, eval_every=5, test_x=tx,
                           test_y=ty, ledger=led, probes=on)
        return state_to_numpy(st), led, 20, "epoch"

    def table3(on):
        led = RunLedger()
        st, *_ = run_defta(0, task, cfg, train, data, epochs=20,
                           scenario="paper_noise@40", eval_every=5,
                           test_x=tx, test_y=ty, ledger=led, probes=on)
        return state_to_numpy(st), led, 20, "epoch"

    def cross_device(on):
        led = RunLedger()
        st, _ = run_cross_device(0, cd_task, cd_cfg, cd_train, cd_data,
                                 world=world, epochs=CD_ROUNDS,
                                 eval_every=10, test_x=cd_data["test_x"],
                                 test_y=cd_data["test_y"], ledger=led,
                                 probes=on)
        return cross_device_state_to_numpy(st), led, CD_ROUNDS, "round"

    def storm_async(on):
        led = RunLedger()
        st, *_ = run_async_defta(0, task, cfg, train, data, ticks=20,
                                 target_epochs=4, check_every=4,
                                 scenario="storm", ledger=led, probes=on)
        return state_to_numpy(st), led, led.rounds_done, "tick"

    # storm appends 3 attackers to the 20 workers: W = 23 at density
    # 0.22, the sparse mix
    return (("table2", table2, "gossip_mix_sparse"),
            ("table3", table3, "gossip_mix_sparse"),
            ("cross_device", cross_device, "gossip_mix"),
            ("storm_async", storm_async, "gossip_mix_sparse"))


def telemetry_parity_and_cost(launches, cache):
    """Each [4m] world four times, probes off, on, on, off (one process,
    one seed): the states with probes on equal those with probes off bit
    for bit, the gossip launch counts are equal, every probe has one row
    a round, and the ms a unit with and without probes (the median over
    the eval chunks of the two runs of each) are printed side by side.
    The launches of the runs with probes on are added to ``launches``."""
    from repro_torch.kernels import ops
    out = {}
    for name, run, kernel in telemetry_worlds(cache):
        res = []
        for on in (False, True, True, False):
            ops.reset_launches()
            fields, led, units, unit = run(on)
            torch.cuda.synchronize()
            res.append((on, fields, led, units, dict(ops.LAUNCHES),
                        dict(ops.REGIMES)))
        offs = [r for r in res if not r[0]]
        ons = [r for r in res if r[0]]
        gap = max(state_gap(a[1], b[1]) for a, b in zip(offs, ons))
        same_launches = all(a[4] == b[4] and a[5] == b[5]
                            for a, b in zip(offs, ons))
        led_on = ons[0][2]
        rows = {n: led_on.series(n).shape[0] for n in led_on.names()}
        units = ons[0][3]

        def ms(rs):
            per = [1e3 * s / n for r in rs
                   for s, n in zip(r[2].superstep_s, chunk_sizes(r[2]))]
            return statistics.median(per)
        ms_off, ms_on = ms(offs), ms(ons)
        out[name] = (ms_off, ms_on)
        print(f"  4m {name:12s} state gap on vs off {gap:.3e} launches "
              f"{ons[0][4][kernel]} equal={same_launches} regimes "
              f"{ons[0][5]} probes {len(rows)} rows/probe "
              f"{sorted(set(rows.values()))} ms/{unit} off "
              f"{ms_off:.3f} on {ms_on:.3f} ({ms_on / ms_off - 1:+.2%})",
              flush=True)
        if gap != 0.0:
            fail(f"4m {name}: the state with probes on differs from the "
                 f"state with probes off by {gap:.3e}")
        if not same_launches:
            fail(f"4m {name}: launches differ with probes on and off")
        if not rows or set(rows.values()) != {units}:
            fail(f"4m {name}: probe rows {rows}, expected {units} each")
        if not ons[0][4][kernel] or sum(ons[0][4].values()) != \
                ons[0][4][kernel]:
            fail(f"4m {name}: launches {ons[0][4]}, expected {kernel} "
                 f"only")
        for r in ons:
            launches[kernel] += r[4][kernel]
    return out


def chunk_sizes(led):
    """The rounds of each chunk a ledger recorded: ``rounds_done`` over
    the chunks, all of one size but the last."""
    n, k = led.rounds_done, len(led.superstep_s)
    size = -(-n // k)
    return [size] * (k - 1) + [n - size * (k - 1)]


def telemetry_no_sync():
    """One chunk of the Table 2 world (5 epochs, no eval) with probes off
    and on under ``torch.cuda.set_sync_debug_mode("warn")``: the run with
    probes must warn of no more host synchronisations than the run
    without (the frames reach the host by asynchronous copies into pinned
    memory before the chunk's own synchronize)."""
    import warnings

    from repro_torch.core.defta import run_defta
    from repro_torch.telemetry import RunLedger
    data, task, cfg, train = table2_world()
    counts = {}
    for on in (False, True, False, True):
        led = RunLedger()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_defta(0, task, cfg, train, data, epochs=5,
                          num_malicious=2, ledger=led, probes=on)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts[on] = sum("synchroniz" in str(w.message).lower()
                         for w in rec)
    print(f"  4m sync warnings in one chunk (Table 2, 5 epochs): probes "
          f"off {counts[False]}, on {counts[True]}", flush=True)
    if counts[True] > counts[False]:
        fail(f"4m: probes add host synchronisations ({counts})")


def launcher_mix_world(w: int, adj, seed: int, dev):
    """P on a launcher world's topology as a round builds it (about half
    the peers sampled, self-loops, row-stochastic) and its padded CSR."""
    from repro_torch.core.gossip import sparse_weights
    rng = np.random.default_rng(seed)
    keep = (adj & (rng.random((w, w)) < 0.5)) | np.eye(w, dtype=bool)
    P = keep * rng.uniform(0.5, 1.5, (w, w))
    P = torch.tensor(P / P.sum(1, keepdims=True), dtype=torch.float32,
                     device=dev)
    idx, val = sparse_weights(P, adj)
    return P, idx, val.contiguous()


def check_launcher_mixes(dev):
    """Each gossip mix that the launcher's worlds run, against its plain
    version at their shapes on the MLP's leaves (F = 2048, 640, 64, 10):
    the scenario worlds' dense mix at W = 10 (``churn_signflip`` on 8
    vanilla workers, avg_peers 4: density 0.5, the stream regime) on fp32
    and int8 rows, the sparse and int8 mixes at W = 60 (``paper_noise@40``
    on 20, density 0.083, its topology's padded CSR), the dense mix at
    k = 64 (the cross-device cohort: the tile regime). Limit 1e-5 (1 +
    max|plain|); each call launches once, in its regime."""
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    worlds = (("churn_signflip", 10, make_topology("random_kout", 10, 4, 0),
               ("float32", "int8"), ("gossip_mix",)),
              ("paper_noise@40", 60, make_topology("random_kout", 60, 4, 0),
               ("float32", "int8"), ("gossip_mix_sparse",
                                     "gossip_mix_quant")),
              ("cohort k=64", 64, np.ones((64, 64), bool), ("float32",),
               ("gossip_mix",)))
    for tag, w, adj, dtypes, names in worlds:
        for f in (2048, 640, 64, 10):
            P, idx, val = launcher_mix_world(w, adj, seed=w + f, dev=dev)
            for dtype in dtypes:
                x, scale = payload(gen, w, f, dtype)
                calls = kernel_calls(ops, ref, P, idx, val, x, scale)
                for name in (n for n in names if n in calls):
                    kern, plain = calls[name]
                    regimes = dict(ops.REGIMES)
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    launched = {k: v - regimes.get(k, 0)
                                for k, v in ops.REGIMES.items()
                                if v != regimes.get(k, 0)}
                    regime = expected_regime(ops, name, w, tag)
                    err = float((got - want).abs().max())
                    tol = 1e-5 * (1.0 + float(want.abs().max()))
                    print(f"  4m check {name:18s} {tag:14s} W={w:3d} "
                          f"F={f:5d} {dtype:8s} max_abs_err={err:.3e} "
                          f"{regime}")
                    if launched != {regime: 1} or not err <= tol:
                        fail(f"4m {name} at {tag} F={f} {dtype}: error "
                             f"{err} (limit {tol}), launches {launched}")


# (label, launcher arguments, the gossip launches by regime it must make,
# whether its rows count epochs or ticks): the CI's smokes
# (.github/workflows/ci.yml), the README's Table 3 and storm commands, and
# the Table 3 world on the int8 wire (the quant mix and ``ef_norm``); every
# run streams its ledger, one of them under --profile
LAUNCHER_RUNS = (
    ("ci scenario", ["--scenario", "churn_signflip", "--sim-epochs", "16",
                     "--assert-acc", "0.3"], {"gossip_mix/stream": 64}),
    ("ci cross-device", ["--cross-device", "--enrolled", "10000",
                         "--sample-k", "64", "--sim-epochs", "6",
                         "--cd-attacks", "label_flip:0.15,alie:0.14",
                         "--dts-signal", "all", "--max-staleness", "6"],
     {"gossip_mix/tile": 24}),
    ("ci secagg", ["--scenario", "churn_signflip", "--sim-epochs", "16",
                   "--secagg", "--gossip-wire", "int8", "--assert-acc",
                   "0.3"], {}),
    ("ci secagg cross-device", ["--cross-device", "--enrolled", "40",
                                "--sample-k", "8", "--sim-epochs", "8",
                                "--secagg", "--dp-sigma", "0.5",
                                "--gossip-wire", "int8"], {}),
    ("ci telemetry", ["--scenario", "churn_signflip", "--sim-epochs", "8"],
     {"gossip_mix/stream": 32}),
    ("readme table3", ["--scenario", "paper_noise@40", "--sim-workers",
                       "20", "--sim-epochs", "50"],
     {"gossip_mix_sparse/slices": 200}),
    ("readme storm async", ["--scenario", "storm", "--async-ticks", "40",
                            "--aggregation", "median"], {}),
    ("table3 int8 wire", ["--scenario", "paper_noise@40", "--sim-workers",
                          "20", "--sim-epochs", "20", "--gossip-wire",
                          "int8"], {"gossip_mix_quant/slices": 80}),
)
PROFILED = "ci telemetry"


def launcher_runs(launches):
    """Each ``LAUNCHER_RUNS`` command through ``python -m
    repro_torch.launch.train`` in a subprocess, with ``--telemetry``: it
    must exit 0 (its ``--assert-acc`` met), launch exactly the gossip
    kernels in the regimes it should, and leave a JSONL ledger of a
    manifest, one round row per epoch or tick run (stamps 0 .. n - 1, as
    many as the summary counts) and a summary, which
    ``benchmarks/render_experiments.py --telemetry-panel`` renders with a
    row per round shown. ``PROFILED`` also runs under ``--profile`` and
    must leave a Chrome trace with the round's stage ranges. The runs'
    launches are added to ``launches``."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv, want in LAUNCHER_RUNS:
            ledger = Path(tmp) / (label.replace(" ", "_") + ".jsonl")
            cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv,
                   "--telemetry", str(ledger)]
            trace_dir = Path(tmp) / "profile"
            if label == PROFILED:
                cmd += ["--profile", str(trace_dir)]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=600)
            wall = time.perf_counter() - t0
            lines = r.stdout.strip().splitlines()
            if r.returncode != 0:
                print("\n".join(lines[-8:]) + "\n" + r.stderr[-3000:])
                fail(f"4m launcher {label}: exit {r.returncode}")
            final = [ln for ln in lines if ln.startswith("final ")]
            counted = json.loads(lines[-1].split(": ", 1)[1])
            regimes = counted["regimes"]
            rows = [json.loads(ln) for ln in ledger.read_text().splitlines()]
            body = [x for x in rows if x["type"] == "round"]
            print(f"  4m launcher {label:22s} {wall:6.1f}s {final[0][:120]} "
                  f"regimes {regimes} rows {len(body)}", flush=True)
            if regimes != want:
                fail(f"4m launcher {label}: regimes {regimes}, expected "
                     f"{want}")
            summary = rows[-1]
            if rows[0]["type"] != "manifest" or summary["type"] != \
                    "summary" or [x["t"] for x in body] != list(
                        range(summary["rounds_recorded"])) or not body:
                fail(f"4m launcher {label}: ledger rows malformed "
                     f"({len(rows)} rows, summary {summary})")
            panel = subprocess.run(
                [sys.executable, "benchmarks/render_experiments.py",
                 "--telemetry-panel", str(ledger)], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=120)
            table = [ln for ln in panel.stdout.splitlines()
                     if ln.startswith("| ")]
            if panel.returncode != 0 or len(table) < 1 + min(len(body), 32):
                fail(f"4m launcher {label}: the panel rendered "
                     f"{len(table)} table lines (exit {panel.returncode})")
            if label == PROFILED:
                trace = trace_dir / "trace.json"
                names = {e.get("name") for e in json.loads(
                    trace.read_text())["traceEvents"]}
                print(f"  4m --profile trace {trace.stat().st_size} bytes, "
                      f"{len(names)} event names; panel:\n    "
                      + "\n    ".join(panel.stdout.splitlines()[:6]))
                if not {"transport", "trust_update"} <= names:
                    fail("4m --profile: no stage ranges in the trace")
            others = {k: n for k, n in counted["launches"].items()
                      if n and k not in GOSSIP}
            if others:
                fail(f"4m launcher {label}: launched {others}")
            for name in GOSSIP:
                launches[name] += counted["launches"][name]


def telemetry_end_to_end(launches):
    """Phase 4m on the card; the phase's launches are added to
    ``launches``."""
    check_launcher_mixes(torch.device("cuda"))
    telemetry_no_sync()
    cost = telemetry_parity_and_cost(launches, {})
    launcher_runs(launches)
    return cost


# ---------------------------------------------------------------------------
# Phase 4w: worker-axis sharding
# ---------------------------------------------------------------------------

# (W, shards) of the local blocks the sharded transport hands the sparse
# and int8 kernels: W_local = 4, 15 (Table 3), 13 (the last block part
# padding) and 1,250
SHARD_BLOCKS = ((16, 4), (60, 4), (100, 8), (10_000, 8))
MLP_LEAVES = (2048, 640, 64, 10)


def shard_block(w, s, si, dev):
    """Shard ``si``'s local block of a W-worker ``random_kout`` topology
    (4 peers, seed 0, as ``run_defta`` makes it) on ``s`` shards: (the
    plan, idx [B, K] int32, val [B, K]: random weights on the valid slots,
    0 on the pad slots, rows normalised)."""
    from repro_torch.core.gossip import _plan_tensors, worker_shard_plan
    from repro_torch.core.topology import make_topology
    plan = worker_shard_plan(make_topology("random_kout", w, 4, 0), s)
    idx, valid = _plan_tensors(plan, str(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(w + si)
    val = torch.rand(valid[si].shape, generator=gen, device=dev) \
        * valid[si]
    val = (val / val.sum(1, keepdim=True)).contiguous()
    return plan, idx[si], val


def check_shard_blocks(dev):
    """The sparse (f32, bf16) and int8 mixes against their plain versions
    at the local-block shapes of ``SHARD_BLOCKS``, the first and the last
    shard's block, the MLP's leaves; limit 1e-5 (1 + max|plain|). Then
    time the local-block kernels at W_local = 15 and 1,250 (F = 2048).
    Returns {kernel: max err}."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    max_err = {"gossip_mix_sparse": 0.0, "gossip_mix_quant": 0.0}
    for w, s in SHARD_BLOCKS:
        for si in (0, s - 1):
            plan, idx, val = shard_block(w, s, si, dev)
            b = plan.block
            for f in MLP_LEAVES:
                for dtype in ("float32", "bfloat16", "int8"):
                    w_in, scale = payload(gen, b, f, dtype)
                    name = "gossip_mix_quant" if scale is not None \
                        else "gossip_mix_sparse"
                    before = ops.LAUNCHES[name]
                    got = ops.gossip_mix_quant(idx, val, scale, w_in) \
                        if scale is not None \
                        else ops.gossip_mix_sparse(idx, val, w_in)
                    torch.cuda.synchronize()
                    want = ref.gossip_mix_quant_ref(idx, val, scale, w_in) \
                        if scale is not None \
                        else ref.gossip_mix_sparse_ref(idx, val, w_in)
                    err = float((got - want).abs().max())
                    tol = 1e-5 * (1.0 + float(want.abs().max()))
                    if ops.LAUNCHES[name] - before != 1 or not err <= tol:
                        fail(f"{name} local block W={w} S={s} shard {si} "
                             f"F={f} {dtype}: err {err:.3e} (tol "
                             f"{tol:.1e}), launches "
                             f"{ops.LAUNCHES[name] - before}")
                    max_err[name] = max(max_err[name], err)
            print(f"  4w block W={w:5d} S={s} shard {si}: W_local={b:4d} "
                  f"K={idx.shape[1]} sparse/quant vs plain max_abs_err "
                  f"{max_err['gossip_mix_sparse']:.3e} / "
                  f"{max_err['gossip_mix_quant']:.3e}", flush=True)
    for w, s in ((60, 4), (10_000, 8)):
        plan, idx, val = shard_block(w, s, 0, dev)
        b, k, f = plan.block, idx.shape[1], 2048
        nnz = int(plan.valid[0].sum())
        w32, _ = payload(gen, b, f, "float32")
        q, scale = payload(gen, b, f, "int8")
        for name, kern, plain, lib, in_bytes in (
                ("gossip_mix_sparse",
                 lambda: ops.gossip_mix_sparse(idx, val, w32),
                 lambda: ref.gossip_mix_sparse_ref(idx, val, w32), True, 4),
                ("gossip_mix_quant",
                 lambda: ops.gossip_mix_quant(idx, val, scale, q),
                 lambda: ref.gossip_mix_quant_ref(idx, val, scale, q),
                 False, 1)):
            csr = torch.sparse_coo_tensor(
                torch.stack([torch.arange(b, device=dev).repeat_interleave(
                    k), idx.reshape(-1).long()]), val.reshape(-1),
                (b, b)).coalesce().to_sparse_csr()
            ms, plain_ms = device_ms(kern), device_ms(plain)
            lib_ms = device_ms(lambda: torch.sparse.mm(csr, w32)) \
                if lib else None
            b_ms, b_by = bound(name, b, nnz, k, f, in_bytes)
            print(f"  4w time {name:18s} W={w:5d} S={s} W_local={b:4d} "
                  f"K={k} F={f} kernel={ms * 1e3:.2f}us plain="
                  f"{plain_ms * 1e3:.2f}us library="
                  f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.2f}'}us "
                  f"bound={b_ms * 1e3:.2f}us ({b_by})", flush=True)
    return max_err


def numpy_state(st):
    """A state's fields as numpy (DeFTAState or CrossDeviceState)."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, dict):
            out[f.name] = {k: x.cpu().numpy() for k, x in v.items()}
        elif v is not None:
            out[f.name] = v.cpu().numpy()
    return out


# fields held exact between a sharded run and an unsharded one
SHARD_EXACT = ("epoch", "last_part", "obs", "sketch", "sketch_round")


def shard_gap(a, b, int8=False):
    """The largest excess of |a - b| over 1e-4 |b| across the float fields
    of two numpy states (rtol and atol 1e-4, the CPU tests' limit, hold
    when it is at most 1e-4; None when an exact field differs); ``int8``:
    params, backup and residuals in units of one quantization step of the
    row (max|row| / 127), one step counting as 1e-4."""
    gap = 0.0
    for f, x in a.items():
        y = b[f]
        if f in SHARD_EXACT:
            if not np.array_equal(x, y):
                return None
            continue
        for k in (x if isinstance(x, dict) else {None: x}):
            u = x[k] if k is not None else x
            v = y[k] if k is not None else y
            d = np.abs(u.astype(np.float64) - v.astype(np.float64)) \
                - 1e-4 * np.abs(v.astype(np.float64))
            d = np.where(np.isfinite(u) & np.isfinite(v), d,
                         np.where(u == v, 0.0, np.inf))
            if int8 and f in ("params", "backup", "wire_err"):
                step = np.abs(a["params"][k].reshape(len(u), -1)).max(1) \
                    / 127.0
                d = d.reshape(len(u), -1) / np.maximum(step, 1e-30)[:, None] \
                    * 1e-4             # one step maps to the 1e-4 limit
            gap = max(gap, float(d.max()))
    return gap


def sharded_pair(label, run, s, kernel, count=None, int8=False,
                 want_ring=None):
    """``run(shards)`` -> (state, ledger) unsharded and on ``s`` shards of
    the card (counters at 0 before the sharded run): the sharded run must
    launch ``kernel`` ``count(ledger)`` times (default: s x 4 leaves x the
    rounds or ticks run, one local block per shard and leaf) and nothing
    else, move ``want_ring(ledger)`` bytes between shards when given, and
    end within 1e-4 of the unsharded run (exact fields equal). Returns
    (launches, ms a round or tick of both runs, sharded state)."""
    from repro_torch.core import gossip
    from repro_torch.kernels import ops
    one, led1 = run(None)
    torch.cuda.synchronize()
    ops.reset_launches()
    gossip.reset_ring()
    st, led = run(s)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    n = count(led) if count is not None else s * 4 * led.rounds_done
    if counts != {kernel: n}:
        fail(f"4w {label}: launches {counts}, expected {{{kernel}: {n}}}")
    if want_ring is not None and gossip.RING["bytes"] != want_ring(led):
        fail(f"4w {label}: ring bytes {gossip.RING['bytes']}, the "
             f"contract {want_ring(led)}")
    gap = shard_gap(numpy_state(one), numpy_state(st), int8)
    if gap is None or not gap <= 1e-4:
        fail(f"4w {label}: sharded vs unsharded gap {gap} (epochs, ticks, "
             f"stamps, counters and sketches must be equal)")
    ms = [1e3 * sum(x.superstep_s) / max(x.rounds_done, 1)
          for x in (led1, led)]
    print(f"  4w {label:34s} S={s} {kernel}={n} ring_bytes="
          f"{gossip.RING['bytes']} gap={gap:.2e} ms/unit unsharded "
          f"{ms[0]:.2f} sharded {ms[1]:.2f}", flush=True)
    return n, ms, st


def shard_world(w, n_per_worker, local_epochs=2):
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    data = federated_dataset("vector", w, np.random.default_rng(0),
                             n_per_worker=n_per_worker, alpha=0.5)
    cfg = DeFTAConfig(num_workers=w, avg_peers=4, num_sampled=2,
                      local_epochs=local_epochs)
    return data, mlp_task(32, 10), cfg, TrainConfig(learning_rate=0.05,
                                                    batch_size=32)


def ring_contract(cfg, adj, s, n_params, leaves=4):
    """The sharded_ring_bytes of one round of ``cfg``'s wire."""
    from repro_torch.core.gossip import normalize_wire
    from repro_torch.launch.roofline import sharded_ring_bytes
    return sharded_ring_bytes(n_params, adj, s,
                              normalize_wire(cfg.gossip_dtype),
                              rows=leaves)["ring_bytes"]


def shard_end_to_end(launches):
    """Phase 4w on the card; the phase's launches are added to
    ``launches``."""
    import warnings

    from repro_torch import sharding
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.cross_device import run_cross_device
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import init_cross_device_state, sketch_shape
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import ops
    from repro_torch.scenarios import compile_world
    from repro_torch.telemetry import RunLedger

    def on_card(s):
        return None if s is None else ["cuda:0"] * s

    def defta(data, task, cfg, train, epochs, s, **kw):
        led = RunLedger()
        st, *_ = run_defta(0, task, cfg, train, data, epochs=epochs,
                           ledger=led, probes=False, device="cuda",
                           shards=s, shard_devices=on_card(s), **kw)
        return st, led

    # the equality runs take 4 epochs, as the reference's shard tests do
    # (SGD amplifies the summation-order differences round by round)
    epochs = 4
    data, task, cfg, train = table2_world()
    n_params = sum(MLP_LEAVES)
    adj22 = make_topology(cfg.topology, 22, cfg.avg_peers, cfg.seed)
    for s in (2, 4):
        n, _, _ = sharded_pair(
            f"Table 2 W=22 fp32 {epochs} epochs",
            lambda sh: defta(data, task, cfg, train, epochs, sh,
                             num_malicious=2, eval_every=2,
                             test_x=data["test_x"], test_y=data["test_y"]),
            s, "gossip_mix_sparse",
            want_ring=lambda led, s=s: led.rounds_done * ring_contract(
                cfg, adj22, s, n_params))
        launches["gossip_mix_sparse"] += n
    # ms an epoch by shard count, in turns (1, 2, 4, 4, 2, 1), 10 epochs
    # each in two chunks of 5; the second chunk is the one kept
    ms_by_s = {1: [], 2: [], 4: []}
    for s in (1, 2, 4, 4, 2, 1):
        _, led = defta(data, task, cfg, train, 10, s if s > 1 else None,
                       num_malicious=2, eval_every=5, test_x=data["test_x"],
                       test_y=data["test_y"])
        ms_by_s[s].append(1e3 * led.superstep_s[-1] / 5)
    print("  4w Table 2 world ms an epoch by shards (probes off, the "
          "second 5-epoch chunk of 10, two runs each): "
          + "; ".join(f"S={k}: {', '.join(f'{x:.2f}' for x in v)}"
                      for k, v in ms_by_s.items()), flush=True)

    cfg8 = dataclasses.replace(cfg, gossip_dtype="int8")
    n, _, _ = sharded_pair(
        "Table 2 int8 + EF21",
        lambda sh: defta(data, task, cfg8, train, epochs, sh,
                         num_malicious=2), 4, "gossip_mix_quant",
        int8=True,
        want_ring=lambda led: led.rounds_done * ring_contract(
            cfg8, adj22, 4, n_params))
    launches["gossip_mix_quant"] += n

    # secagg on the fp32 and int8 wires: sharded secagg = sharded
    # plaintext bit for bit (the local blocks still run their kernels)
    for wire, kernel in (("float32", "gossip_mix_sparse"),
                         ("int8", "gossip_mix_quant")):
        c_plain = dataclasses.replace(cfg, gossip_dtype=wire)
        c_sec = dataclasses.replace(c_plain, secagg="pairwise")
        plain, _ = defta(data, task, c_plain, train, 4, 4, num_malicious=2)
        ops.reset_launches()
        sec, _ = defta(data, task, c_sec, train, 4, 4, num_malicious=2)
        torch.cuda.synchronize()
        a, b = numpy_state(plain), numpy_state(sec)
        same = all(np.array_equal(a[f][k], b[f][k]) for f in a
                   if isinstance(a[f], dict) for k in a[f]) and all(
            np.array_equal(a[f], b[f], equal_nan=True) for f in a
            if not isinstance(a[f], dict))
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"  4w secagg {wire:7s} S=4 sharded secagg == sharded "
              f"plaintext bit for bit: {same}; launches {got}", flush=True)
        if not same or got != {kernel: 4 * 4 * 4}:
            fail(f"4w secagg {wire}: equal {same}, launches {got}")
        launches[kernel] += got[kernel]

    # the Table 3 world: 20 vanilla + 40 alie colluders under all, one
    # round (past it the geometry channel's half-mass tie lets float
    # summation order decide a receiver's norm median: ROADMAP queue 3)
    from repro_torch.scenarios import AttackSpec, ScenarioSpec
    t3 = dataclasses.replace(cfg, local_epochs=1, dts_signal="all")
    alie = ScenarioSpec(name="alie_k40", attacks=tuple(
        AttackSpec("alie") for _ in range(40)))
    n, _, st = sharded_pair(
        "Table 3 W=60 alie@40 all, 1 round",
        lambda sh: defta(data, task, t3, train, 1, sh, scenario=alie), 4,
        "gossip_mix_sparse")
    if st.conf.shape != (60, 60) or not float(st.sketch.abs().max()) > 0:
        fail("4w Table 3: world or sketch not as built")
    launches["gossip_mix_sparse"] += n

    # W = 100 on 8 shards: warned, state whole, transport padded (8 blocks
    # of 13, the last 9 real rows)
    d100, task100, c100, tr100 = shard_world(100, 32)
    sharding._DEMOTION_WARNED.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        n, _, _ = sharded_pair(
            "W=100 on 8 shards (padded)",
            lambda sh: defta(d100, task100, c100, tr100, 2, sh), 8,
            "gossip_mix_sparse")
    if not any("not divisible" in str(r.message) for r in rec):
        fail("4w W=100 on 8 shards: no 'not divisible' warning")
    launches["gossip_mix_sparse"] += n

    # async storm on 4 shards (W = 23: one block, the transport padded),
    # 4 ticks: past them the sign_flip attacker's model grows without
    # bound and carries the two runs' last-bit differences with it (8
    # ticks on the CPU: 0.14 apart at |w| = 23, the vanilla workers within
    # 1e-4)
    def storm(sh):
        led = RunLedger()
        st, *_ = run_async_defta(0, task, cfg, train, data, ticks=4,
                                 scenario="storm", ledger=led,
                                 probes=False, device="cuda", shards=sh,
                                 shard_devices=on_card(sh))
        return st, led
    n, _, _ = sharded_pair("async storm 4 ticks", storm, 4,
                           "gossip_mix_sparse")
    launches["gossip_mix_sparse"] += n

    # the launcher's cross-device world (10,000 enrolled, k = 64) with the
    # enrolled rows on 4 shards: the k-block keeps its 4 tile launches
    cache = {}
    ctask, ccfg, ctrain, cdata, spec = cross_device_world(cache)
    rounds = 6
    world = compile_world(spec, rounds)

    def cross(sh):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        init = init_cross_device_state(gen, ctask, world.enrolled,
                                       sketch=sketch_shape(ccfg))
        led = RunLedger()
        st, _ = run_cross_device(0, ctask, ccfg, ctrain, cdata,
                                 world=world, epochs=rounds, ledger=led,
                                 probes=False, init=init, device="cuda",
                                 shards=sh,
                                 shard_devices=on_card(sh))
        return st, led
    ops.reset_launches()
    n, _, _ = sharded_pair("cross-device N=10,000 k=64, 6 rounds", cross,
                           4, "gossip_mix", lambda led: 4 * led.rounds_done)
    if ops.REGIMES != {"gossip_mix/tile": 4 * rounds}:
        fail(f"4w cross-device: regimes {ops.REGIMES}")
    launches["gossip_mix"] += n

    # full width: W = 10,000 on 8 shards, 2 epochs
    dw, taskw, cw, _ = shard_world(10_000, 8, local_epochs=1)
    trw = dataclasses.replace(train, batch_size=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    st, led = defta(dw, taskw, cw, trw, 2, 8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    state_gb = sum(x.nbytes for f in numpy_state(st).values()
                   for x in (f.values() if isinstance(f, dict) else [f])) \
        / 1e9
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    print(f"  4w full width W=10,000 S=8 2 epochs: wall {wall:.2f}s, "
          f"chunks {led.as_stats()['dispatches']}, launches {counts}, "
          f"state {state_gb:.3f} GB ({state_gb / 8:.3f} GB a shard), card "
          f"peak {peak:.2f} GB (all 8 shards on one card)", flush=True)
    if not bool((st.epoch == 2).all()) or counts != {
            "gossip_mix_sparse": 8 * 4 * 2} or \
            not bool(torch.isfinite(st.last_loss).all()):
        fail(f"4w full width: epochs {st.epoch.unique().tolist()}, "
             f"launches {counts}")
    launches["gossip_mix_sparse"] += counts["gossip_mix_sparse"]


# ---------------------------------------------------------------------------
# Phase 4f: LM training and DeFTA across pods (--fl)
# ---------------------------------------------------------------------------

FL_PODS, FL_STEPS, FL_EVERY = 4, 8, 4
# the launcher's --fl arguments at paper-small's full width (2 layers, d 256,
# vocab 33,278, bf16; seq 128, batch 8: 2 a pod), per run
FL_RUNS = {
    "in_jit fp32": [],
    "in_jit int8+EF": ["--gossip-wire", "int8"],
    "ring fp32": ["--transport", "ppermute"],
    "ring int8+EF": ["--transport", "ppermute", "--gossip-wire", "int8"],
    "dts all+time machine": ["--pod-dts", "--dts-signal", "all",
                             "--pod-time-machine"],
}


def event_ms(fn, calls: int = 10, repeats: int = 5) -> float:
    """Median device-and-host milliseconds per call between CUDA events,
    ``calls`` back-to-back calls a repeat, after a warm-up (for work a
    CUDA graph cannot capture, such as an autograd backward)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def check_flash_grad(dev):
    """The flash kernel under autograd (``ops._FlashAttention``: the kernel
    forward, the plain version's gradient recomputed from q, k, v) against
    the plain version's forward and gradient, at the [4f] pods' shape
    [2, 4, 128, 64] bf16 (``flash_attention_tc``) and the example's
    [4, 12, 128, 64] f32 (SIMT ``flash_attention``), in the model's layout
    (views of [B, S, H, D] tensors), causal. Limits: the forward as [2]'s
    (``ref.flash_tc_limit`` / ``flash_err``); dq, dk, dv equal to the plain
    version's within 1e-6 of their max |.|. The backward is the plain
    version's, so the gradient check is a plumbing check of the wrapper
    (the saved q, k, v reach the recompute, the grads come back in the
    model's layout), not a check of a kernel. Times the kernel forward, the recompute backward and
    the plain forward + backward. Returns {kernel: max forward err}."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    worst = {}
    for (b, h, s, d), dtype in (((2, 4, 128, 64), torch.bfloat16),
                                ((4, 12, 128, 64), torch.float32)):
        name = ops.flash_kernel(dtype, d)
        base = [torch.randn(b, s, h, d, generator=gen, device=dev)
                .to(dtype) for _ in range(3)]
        go = torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)

        def leaves():
            return [t.detach().clone().requires_grad_().transpose(1, 2)
                    for t in base]
        q, k, v = leaves()
        before = dict(ops.LAUNCHES)
        out = ops.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), go)
        grad_fn = type(out.grad_fn).__name__
        out = out.detach()
        torch.cuda.synchronize()
        launched = {n: ops.LAUNCHES[n] - before[n] for n in
                    ("flash_attention", "flash_attention_tc")}
        if launched != {n: int(n == name) for n in launched} or \
                grad_fn != "_FlashAttentionBackward":
            fail(f"4f flash under autograd {dtype}: launches {launched}, "
                 f"grad_fn {grad_fn}")
        pq, pk, pv = leaves()
        want = ref.flash_attention_ref(pq, pk, pv, causal=True)
        pgrads = torch.autograd.grad(want, (pq, pk, pv), go)
        want = want.detach()
        if name == "flash_attention_tc":
            lim = ref.flash_tc_limit(*(t.detach() for t in (q, k, v)), want,
                                     causal=True)
            diff = (out.float() - want.float()).abs()
            err, ratio = float(diff.max()), float((diff / lim).max())
        else:
            err, ratio = flash_err(out, want, dtype)
        gerr = [float((g.float() - p.float()).abs().max())
                for g, p in zip(grads, pgrads)]
        glim = [1e-6 * float(p.float().abs().max()) for p in pgrads]
        fwd = device_ms(lambda: ops.flash_attention(q.detach(), k.detach(),
                                                    v.detach(), causal=True))

        def kernel_bwd():
            qq, kk, vv = leaves()
            o = ops.flash_attention(qq, kk, vv, causal=True)
            torch.autograd.grad(o, (qq, kk, vv), go)

        def plain_fwd_bwd():
            qq, kk, vv = leaves()
            o = ref.flash_attention_ref(qq, kk, vv, causal=True)
            torch.autograd.grad(o, (qq, kk, vv), go)
        both = event_ms(kernel_bwd)
        plain = event_ms(plain_fwd_bwd)
        print(f"  4f flash grad {name:18s} {[b, h, s, d]} "
              f"{str(dtype)[6:]:8s} fwd max_abs_err={err:.3e} "
              f"err/limit={ratio:.3f}; dq/dk/dv (plumbing) max_abs_err="
              f"{['%.2e' % e for e in gerr]}; kernel fwd {fwd:.4f} ms, "
              f"kernel fwd + recompute bwd {both:.4f} ms (bwd "
              f"{both - fwd:.4f}), plain fwd + bwd {plain:.4f} ms")
        if not ratio <= 1.0 or any(not e <= lim for e, lim in
                                   zip(gerr, glim)):
            fail(f"4f flash under autograd {dtype}: forward ratio {ratio}, "
                 f"gradient errors {gerr} (limits {glim})")
        worst[name] = err
    return worst


def fl_args(extra):
    from repro_torch.launch import train
    argv = ["--fl", "--pods", str(FL_PODS), "--steps", str(FL_STEPS),
            "--gossip-every", str(FL_EVERY), "--batch", "8", "--seq", "128",
            *extra]
    args = train.parser().parse_args(argv)
    args.argv = ["chip_smoke.py", *argv]
    return args


def fl_end_to_end(dev):
    """``launch.train.train_lm`` (``--fl``) at paper-small's full width, 4
    pods on the card, 8 steps, a gossip round every 4, on each of
    ``FL_RUNS``: every pod's loss finite and its mean falling from the
    first step to the last; flash_attention_tc launches = pods x layers x
    steps (forward only; the time machine's held-out evaluations add pods
    x layers a round), no other kernel launch (the einsum backend and the
    ring run none); on the ring, the bytes moved = rounds x
    ``roofline.ppermute_ring_bytes`` exactly (the fp32 wire ships the
    bf16 leaves in their dtype, as the reference's ppermute does, so it
    is priced as "bf16"). Prints ms a step (median past the first), ms a
    gossip round and peak memory. Returns (flash_attention_tc launches,
    the last run's pod params)."""
    from repro_torch.core import gossip
    from repro_torch.core import pods as pods_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline, train

    total, out = 0, None
    for label, extra in FL_RUNS.items():
        args = fl_args(extra)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        gossip.reset_ring()
        t0 = time.perf_counter()
        out = train.train_lm(args)
        wall = time.perf_counter() - t0
        losses = np.asarray(out["losses"])
        flat = pods_mod.flatten(out["params"][0])
        layers = 2
        rounds = FL_STEPS // FL_EVERY
        tm = "--pod-time-machine" in extra
        want = {k: 0 for k in ops.LAUNCHES}
        want["flash_attention_tc"] = FL_PODS * layers * (
            FL_STEPS + (rounds if tm else 0))
        got = dict(ops.LAUNCHES)
        ring = "ppermute" in extra
        # on the fp32 wire the ring ships each leaf in its own dtype, as
        # the reference's ppermute does: paper-small's bf16, 2 bytes each
        bf16 = next(iter(flat.values())).dtype == torch.bfloat16
        wire = "int8" if "int8" in extra else ("bf16" if bf16 else None)
        n_params = sum(v.numel() for v in flat.values())
        nnz, _ = roofline.ppermute_ring_bytes(
            n_params, np.ones((FL_PODS, FL_PODS), bool), wire,
            rows=len(flat))
        ring_want = rounds * nnz if ring else 0
        step_ms = 1e3 * float(np.median(out["step_s"][1:]))
        gossip_ms = [round(1e3 * x, 2) for x in out["gossip_s"]]
        print(f"  4f --fl {label:22s} transport={out['transport'].kind} "
              f"losses first {losses[0].round(4).tolist()} last "
              f"{losses[-1].round(4).tolist()}; ms a step {step_ms:.2f}, "
              f"gossip round ms {gossip_ms}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, wall "
              f"{wall:.1f}s; flash launches {got['flash_attention_tc']}; "
              f"ring bytes {gossip.RING['bytes']}", flush=True)
        if not np.isfinite(losses).all() or \
                not losses[-1].mean() < losses[0].mean():
            fail(f"4f --fl {label}: losses {losses.tolist()}")
        if got != want:
            fail(f"4f --fl {label}: launches {got}, expected {want}")
        if gossip.RING["bytes"] != ring_want:
            fail(f"4f --fl {label}: ring bytes {gossip.RING['bytes']}, "
                 f"expected {ring_want}")
        if out["pstate"].round != rounds:
            fail(f"4f --fl {label}: {out['pstate'].round} gossip rounds")
        total += got["flash_attention_tc"]
    return total, out["params"]


def fl_pod_mixes(dev, pod_params, launches, max_err):
    """The pod round's transports at pod width on the trained pods' params
    (paper-small's leaves, cast to f32): the ring equals the in-process
    einsum mix within 1e-5 on the fp32 wire and within one quantization
    step of the row on int8, its bytes ``ppermute_ring_bytes`` exactly;
    then the pod round with ``backend="pallas"`` (the dense mix, stream
    regime), ``"sparse"`` (the padded-CSR mix) and the int8 wire on
    ``"sparse"`` (the quant mix): each mix kernel launches once a leaf a
    round and holds its plain version at each leaf's [4, F] within 1e-5
    (1 + max|plain|); the round's params equal the einsum round's within
    1e-5 (int8: one step)."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.core import engine, gossip
    from repro_torch.core import pods as pods_mod
    from repro_torch.core.gossip import sparse_weights
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import roofline
    from repro_torch.rng import TorchDraws

    w = FL_PODS
    adj = make_topology("dense", w, w - 1)
    flats = [{k: v.float() for k, v in pods_mod.flatten(p).items()}
             for p in pod_params]
    n_params = sum(v.numel() for v in flats[0].values())
    rng = np.random.default_rng(4)
    keep = (adj & (rng.random((w, w)) < 0.7)) | np.eye(w, dtype=bool)
    P = keep * rng.uniform(0.5, 1.5, (w, w))
    P = torch.tensor(P / P.sum(1, keepdims=True), dtype=torch.float32,
                     device=dev)
    for wire in (None, "int8"):
        cfg = DeFTAConfig(num_workers=w, avg_peers=w - 1, topology="dense",
                          gossip_dtype="float32" if wire is None else wire,
                          gossip_error_feedback=False)
        gossip.reset_ring()
        ring, _ = engine.make_transport(cfg, adjacency=adj,
                                        pods=[dev] * w).mix_pods(P, flats)
        inproc, _ = engine.make_transport(cfg, backend="einsum",
                                          adjacency=adj).mix_pods(P, flats)
        nnz, _ = roofline.ppermute_ring_bytes(n_params, adj, wire,
                                              rows=len(flats[0]))
        worst = 0.0
        for a, b in zip(ring, inproc):
            for k in a:
                diff = (a[k] - b[k]).abs().reshape(-1)
                bound = 1e-5 if wire is None else float(
                    torch.stack([f[k] for f in flats]).abs().max()) / 127
                worst = max(worst, float(diff.max()) / bound)
        print(f"  4f ring vs in-process mix, {wire or 'fp32'} wire: worst "
              f"err/limit {worst:.3f}; ring bytes {gossip.RING['bytes']} "
              f"(contract {nnz})")
        if not worst <= 1.0 or gossip.RING["bytes"] != nnz:
            fail(f"4f ring {wire}: err/limit {worst}, bytes "
                 f"{gossip.RING['bytes']} vs {nnz}")

    idx, val = sparse_weights(P, adj)
    val = val.contiguous()
    for k in sorted(flats[0]):
        x = torch.stack([f[k].reshape(-1) for f in flats]).contiguous()
        q, s = gossip.quantize_rows_int8(x)
        for name, (kern, plain) in {
                **kernel_calls(ops, ref, P, idx, val, x, None),
                **{n: c for n, c in kernel_calls(ops, ref, P, idx, val,
                                                 q, s).items()
                   if n == "gossip_mix_quant"}}.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = float((got - want).abs().max())
            tol = 1e-5 * (1.0 + float(want.abs().max()))
            if not err <= tol:
                fail(f"4f {name} at pod width, leaf {k} [4, {x.shape[1]}]: "
                     f"err {err} (limit {tol})")
            max_err[name] = max(max_err[name], err)
    print(f"  4f the three mixes vs plain at the pods' {len(flats[0])} "
          f"leaves (F up to {max(v.numel() for v in flats[0].values())}): "
          f"max_abs_err { {n: '%.2e' % max_err[n] for n in GOSSIP} }")

    def pod_round(backend, wire):
        cfg = DeFTAConfig(num_workers=w, avg_peers=w - 1, num_sampled=2,
                          topology="dense", use_dts=True,
                          gossip_dtype="float32" if wire is None else wire,
                          gossip_error_feedback=False)
        tr = engine.make_transport(cfg, backend=backend, adjacency=adj)
        rnd = engine.build_pod_round(
            cfg, w, np.full(w, 2), transport=tr, adj=adj, device=dev,
            draws=TorchDraws(torch.Generator(device=dev).manual_seed(7)))
        pst = engine.init_pod_state(w, pod_params, device=dev)
        trees = [pods_mod.rebuild(p, f) for p, f in zip(pod_params, flats)]
        ops.reset_launches()
        t0 = time.perf_counter()
        pst, out = rnd(pst, trees, torch.arange(w, dtype=torch.float32,
                                                device=dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return [pods_mod.flatten(o) for o in out], dict(ops.LAUNCHES), ms

    for backend, wire, kernel in (("pallas", None, "gossip_mix"),
                                  ("sparse", None, "gossip_mix_sparse"),
                                  ("sparse", "int8", "gossip_mix_quant")):
        got, counts, ms = pod_round(backend, wire)
        want, _, base_ms = pod_round("einsum", wire)
        worst = 0.0
        for a, b in zip(got, want):
            for k in a:
                bound = 1e-5 * (1.0 + float(b[k].abs().max())) \
                    if wire is None else float(torch.stack(
                        [f[k] for f in flats]).abs().max()) / 127
                worst = max(worst, float((a[k] - b[k]).abs().max()) / bound)
        expect = {n: 0 for n in counts}
        expect[kernel] = len(flats[0])
        print(f"  4f pod round backend={backend} wire={wire or 'fp32'}: "
              f"{counts[kernel]} {kernel} launches, vs einsum err/limit "
              f"{worst:.3f}, round ms {ms:.2f} (einsum {base_ms:.2f})")
        if counts != expect or not worst <= 1.0:
            fail(f"4f pod round {backend} {wire}: launches {counts}, "
                 f"err/limit {worst}")
        launches[kernel] += counts[kernel]


def fl_example(dev):
    """Ten steps of ``examples/port_train_federated.py`` (the ~100M f32
    dense LM, 12 layers, 4 workers on the card, gossip every 5): finite
    losses, SIMT flash launches = workers x layers x steps. Returns the
    launches."""
    import importlib.util
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "port_train_federated", ROOT / "examples" / "port_train_federated.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = mod.main(["--steps", "10", "--gossip-every", "5"])
    want = {k: 0 for k in ops.LAUNCHES}
    want["flash_attention"] = 4 * 12 * 10
    print(f"  4f example: ms a step {1e3 * np.median(out['step_s'][1:]):.2f}"
          f", peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
          f"launches {dict(ops.LAUNCHES)}")
    if dict(ops.LAUNCHES) != want or not bool(
            torch.isfinite(out["losses"]).all()):
        fail(f"4f example: launches {dict(ops.LAUNCHES)}, losses "
             f"{out['losses'].tolist()}")
    return want["flash_attention"]


# ---------------------------------------------------------------------------
# Phase 5: serving end to end
# ---------------------------------------------------------------------------

def n_params(tree) -> int:
    return sum(n_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


def to_device(tree, dev):
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def prefill_launches(prefill, params, batch, vocab, want_counts, calls):
    """``calls`` prefill calls, each checked for exactly ``want_counts``
    kernel launches (0 for the others) and finite logits of shape
    batch + (vocab,); returns the wall ms of each."""
    from repro_torch.kernels import ops
    times = []
    bs = tuple(batch["tokens"].shape)
    for _ in range(calls):
        before = dict(ops.LAUNCHES)
        logits, ms = wall_ms(lambda: prefill(params, batch))
        times.append(ms)
        delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        want = {k: want_counts.get(k, 0) for k in ops.LAUNCHES}
        if delta != want:
            fail(f"prefill {bs}: launches {delta}, expected {want}")
        if tuple(logits.shape) != bs + (vocab,) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"prefill {bs}: logits {tuple(logits.shape)} not finite or "
                 f"of the wrong shape")
        del logits
    return times


def serve_full(dev):
    """DeepSeekMoE-16B at full width and depth: init, two prefill shapes,
    the serve loop; returns the serving kernels' launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    cfg = get_config("deepseek-moe-16b")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, init_ms = wall_ms(lambda: model.init_params(gen, cfg))
    n = n_params(params)
    print(f"  deepseek-moe-16b: {n} parameters ({cfg.dtype}), init "
          f"{init_ms / 1e3:.2f}s, peak memory after init "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if n != n_params(model.abstract_params(cfg)):
        fail(f"parameter count {n}")
    prefill = build_prefill_step(cfg)
    shapes = ((4, 512), (1, 4096))
    batches = {bs: {"tokens": torch.randint(0, cfg.vocab_size, bs,
                                            generator=gen, device=dev)}
               for bs in shapes}
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                            device=dev)
    for bs in shapes:                                # warm-up, not counted
        prefill(params, batches[bs])
    serve.generate(params, cfg, prompts[:, :2], 2)

    ops.reset_launches()
    for bs in shapes:
        times = prefill_launches(prefill, params, batches[bs],
                                 cfg.vocab_size, {"flash_attention_tc": 28,
                                                  "moe_route_slots": 27}, 3)
        print(f"  prefill B={bs[0]} S={bs[1]}: wall_ms="
              f"{[round(x, 2) for x in times]} launches per call: 28 "
              f"tensor-core flash, 0 SIMT flash, 27 route-and-slot, 0 "
              f"router")
    before = dict(ops.LAUNCHES)
    tokens, st = serve.generate(params, cfg, prompts, 32)
    delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    steps = 32 + 32                  # prompt steps + new tokens
    want = {k: 0 for k in ops.LAUNCHES}
    want["moe_router"] = 27 * steps
    if delta != want:
        fail(f"serve loop: launches {delta}, expected {want}")
    if tuple(tokens.shape) != (4, 32) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        fail("serve loop: bad tokens")
    print(f"  serve batch=4 prompt=32 new=32 greedy: prefill "
          f"{st['prefill_s']:.3f}s, decode {st['decode_s']:.3f}s, "
          f"{st['tok_per_s']:.1f} tok/s, {st['decode_s'] / 32 * 1e3:.2f} "
          f"ms/step; launches {delta}")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    counts = {k: ops.LAUNCHES[k] for k in SERVING}
    del params
    torch.cuda.empty_cache()
    return counts


def serve_reduced_card_vs_cpu(dev, arch, seq, attention, cfg=None):
    """A reduced ``arch`` (f32; or ``cfg`` when given) from one set of
    parameters on the card (kernels) and on the CPU (plain versions):
    prefill logits of 3 x ``seq`` tokens within 1e-4 (summation order:
    cuBLAS vs CPU GEMMs, the kernels vs their plain versions), equal greedy
    tokens, and on the card teacher-forced decode equal to the prefill
    within 2e-3 (tests/test_arch_smoke.py's bound). An encoder-decoder gets
    its frames (drawn with the tokens; its decode steps the encoder states
    of one ``encode``). Returns the kernel launches of these runs (counts
    set to 0 just before them): with ``attention``, SIMT flash launches
    (f32 attention runs the SIMT kernel), and never a tensor-core flash
    launch."""
    from repro_torch.kernels import ops
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_decode_step, \
        build_prefill_step
    from repro_torch.models import model

    cfg = cfg or reduced(get_config(arch))
    gen = torch.Generator()
    gen.manual_seed(1)
    ops.reset_launches()
    cpu_params = model.init_params(gen, cfg)
    card_params = to_device(cpu_params, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, seq),
                                     generator=gen)}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = torch.randn(
            (3, cfg.encoder_seq_len, cfg.d_model), generator=gen)
    card_batch = to_device(batch, dev)
    tokens, frames = batch["tokens"], batch.get("frame_embeds")
    prefill = build_prefill_step(cfg)
    a = prefill(card_params, card_batch).cpu()
    b = prefill(cpu_params, batch)
    err = float((a - b).abs().max())
    ga, _ = serve.generate(card_params, cfg, tokens[:, :8].to(dev), 12,
                           frame_embeds=card_batch.get("frame_embeds"))
    gb, _ = serve.generate(cpu_params, cfg, tokens[:, :8], 12,
                           frame_embeds=frames)
    same = bool(torch.equal(ga.cpu(), gb))
    full = build_prefill_step(cfg, moe_strategy="dense")(card_params,
                                                         card_batch)
    decode = build_decode_step(cfg)
    enc = None
    if cfg.is_encoder_decoder:
        with torch.no_grad():
            enc = model.encode(card_params, cfg, card_batch["frame_embeds"])
    cache = model.init_cache(cfg, 3, seq, device=dev)
    tf_err = 0.0
    for t in range(seq):
        lg, cache = decode(card_params, tokens[:, t:t + 1].to(dev), cache, t,
                           enc)
        tf_err = max(tf_err, float((lg[:, 0] - full[:, t]).abs().max()))
    print(f"  {cfg.name} f32 S={seq} card-vs-cpu: max|logit diff|="
          f"{err:.3e} (tol 1e-4), greedy tokens equal={same}; teacher-forced "
          f"decode vs prefill on the card max diff={tf_err:.3e} (tol 2e-3)")
    if not (err <= 1e-4 and same and tf_err < 2e-3):
        fail(f"{cfg.name}: card and CPU disagree")
    counts = dict(ops.LAUNCHES)
    print(f"  {cfg.name} card launches: {counts}")
    if counts["flash_attention_tc"] or bool(counts["flash_attention"]) \
            != attention:
        fail(f"{cfg.name} (f32): flash launches {counts}, expected SIMT "
             f"launches only")
    return counts


# ---------------------------------------------------------------------------
# Phase 8: whisper-tiny and the InternVL2-2B vision prefix
# ---------------------------------------------------------------------------

# (arch, parameters (repro.models.model.abstract_params), prefill tokens,
# vision tokens, flash_attention_tc launches per prefill call and per serve
# loop): whisper-tiny's 4 encoder, 4 causal decoder and 4 cross-attention
# layers at the decoder context of arXiv:2212.04356 (448 tokens over 1,500
# frames), its serve loop's single encode; InternVL2-2B's 24 layers over
# 256 vision + 512 text tokens, its token-only serve loop
ENCDEC_MODELS = (("whisper-tiny", 36_455_040, 448, 0, 12, 4),
                 ("internvl2-2b", 1_897_537_536, 512, 256, 24, 0))


def encdec_steps_no_sync(params, cfg, frames, prompts, arch, steps=8):
    """An encoder-decoder's serve steps make no host synchronisation: a
    fresh cache, the encode and ``steps`` greedy decode steps (the body of
    ``serve.generate`` without its timing synchronisations), once under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import model
    decode = build_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            cache = model.init_cache(cfg, prompts.shape[0], steps)
            enc = model.encode(params, cfg, frames)
            tok = prompts[:, :1]
            for t in range(steps):
                logits, cache = decode(params, tok, cache, t, enc)
                tok = logits[:, -1].argmax(-1, keepdim=True)
    except RuntimeError as e:
        fail(f"{arch} serve steps synchronise with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        fail(f"{arch} serve steps: non-finite logits")
    print(f"  {arch} encode + {steps} greedy decode steps: no host "
          f"synchronisation", flush=True)


def serve_encdec(dev):
    """Phase [8]: whisper-tiny and InternVL2-2B at full width and depth
    (bf16, random weights from seed 0) initialised on the card and checked
    against their parameter counts; 3 ``build_prefill_step`` calls at B = 4
    (``ENCDEC_MODELS``' shapes, frames and vision embeddings drawn on the
    card) after a warm-up, each with exactly its tensor-core flash
    launches and nothing else (0 SIMT flash), finite logits of the text
    positions; then the serve loop at its defaults (batch 4, prompt 32, 32
    new tokens, greedy; whisper with 1,500 frames), with the encode's
    launches only; peak memory; whisper's serve steps checked to make no
    host synchronisation (``encdec_steps_no_sync``, during the warm-up)
    and the host time of its positions table built uncached.
    Returns the flash_attention_tc launches of these runs (counts set to 0
    just before each model's)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import layers, model

    total = 0
    for arch, want_n, seq, vision, per_call, per_loop in ENCDEC_MODELS:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params, init_ms = wall_ms(lambda: model.init_params(gen, cfg))
        n = n_params(params)
        print(f"  {arch}: {n} parameters ({cfg.dtype}), head dim "
              f"{cfg.head_dim}, init {init_ms / 1e3:.2f}s, peak memory after "
              f"init {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if n != want_n or n != n_params(model.abstract_params(cfg)):
            fail(f"{arch} parameter count {n}, expected {want_n}")
        dt = params["embedding"].dtype
        prefill = build_prefill_step(cfg)
        batch = serve.serve_inputs(cfg, 4, seq, gen, vision=vision, dtype=dt)
        req = serve.serve_inputs(cfg, 4, 32, gen, dtype=dt)
        frames = req.get("frame_embeds")
        prefill(params, batch)                           # warm-up
        serve.generate(params, cfg, req["tokens"][:, :2], 2,
                       frame_embeds=frames)
        if frames is not None:
            encdec_steps_no_sync(params, cfg, frames, req["tokens"], arch)
            table_ms = wall_ms(lambda: layers._sinusoid_table.__wrapped__(
                cfg.encoder_seq_len, cfg.d_model, False))[1]
            print(f"  sinusoid table {cfg.encoder_seq_len} x {cfg.d_model} "
                  f"built uncached: {table_ms:.3f} ms of host time (kept "
                  f"per shape)")

        ops.reset_launches()
        times = prefill_launches(prefill, params, batch, cfg.vocab_size,
                                 {"flash_attention_tc": per_call}, 3)
        shape = f"B=4 S={seq}" + (f" + {cfg.encoder_seq_len} frames"
                                  if frames is not None else "") + \
            (f" + {vision} vision tokens" if vision else "")
        print(f"  prefill {shape}: wall_ms={[round(x, 2) for x in times]} "
              f"launches per call: {per_call} tensor-core flash, 0 SIMT "
              f"flash")
        before = dict(ops.LAUNCHES)
        tokens, st = serve.generate(params, cfg, req["tokens"], 32,
                                    frame_embeds=frames)
        delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        want = {k: 0 for k in ops.LAUNCHES}
        want["flash_attention_tc"] = per_loop
        if delta != want:
            fail(f"{arch} serve loop: launches {delta}, expected {want}")
        if tuple(tokens.shape) != (4, 32) or int(tokens.min()) < 0 \
                or int(tokens.max()) >= cfg.vocab_size:
            fail(f"{arch} serve loop: bad tokens")
        print(f"  serve batch=4 prompt=32 new=32 greedy: prefill "
              f"{st['prefill_s']:.3f}s, decode {st['decode_s']:.3f}s, "
              f"{st['tok_per_s']:.1f} tok/s, {st['decode_s'] / 32 * 1e3:.2f} "
              f"ms/step; {per_loop} tensor-core flash launches in the loop")
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"GB")
        total += ops.LAUNCHES["flash_attention_tc"]
        del params, batch, req, frames
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Phases 6 and 7: the ssm and hybrid families
# ---------------------------------------------------------------------------

def serve_mamba2(dev):
    """Mamba2-780M at full width and depth (48 layers, bf16, random
    weights from seed 0): init on the card, prefill at B=4/S=2048 (G = 32)
    and B=1/S=16384 (G = 64), 3 calls each after a warm-up with 48
    ssd_chunk_tc launches per call and nothing else,
    then the serve loop at its defaults, which launches no kernel (decode
    is the plain recurrence). Returns the SSD kernel's launches of the
    prefill calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    cfg = get_config("mamba2-780m")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, init_ms = wall_ms(lambda: model.init_params(gen, cfg))
    n = n_params(params)
    print(f"  mamba2-780m: {n} parameters ({cfg.dtype}), init "
          f"{init_ms / 1e3:.2f}s, peak memory after init "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if n != MAMBA2_PARAMS or n != n_params(model.abstract_params(cfg)):
        fail(f"mamba2-780m parameter count {n}, expected {MAMBA2_PARAMS}")
    prefill = build_prefill_step(cfg)
    shapes = ((4, 2048), (1, 16384))
    batches = {bs: {"tokens": torch.randint(0, cfg.vocab_size, bs,
                                            generator=gen, device=dev)}
               for bs in shapes}
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                            device=dev)
    for bs in shapes:                                # warm-up, not counted
        prefill(params, batches[bs])
    serve.generate(params, cfg, prompts[:, :2], 2)

    ops.reset_launches()
    for bs in shapes:
        times = prefill_launches(prefill, params, batches[bs],
                                 cfg.vocab_size, {"ssd_chunk_tc": 48}, 3)
        print(f"  prefill B={bs[0]} S={bs[1]}: wall_ms="
              f"{[round(x, 2) for x in times]} launches per call: 48 "
              f"ssd_chunk_tc")
    counts = {"ssd_chunk_tc": ops.LAUNCHES["ssd_chunk_tc"]}
    before = dict(ops.LAUNCHES)
    tokens, st = serve.generate(params, cfg, prompts, 32)
    delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    if any(delta.values()):
        fail(f"mamba2 serve loop: launches {delta}, expected none")
    if tuple(tokens.shape) != (4, 32) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        fail("mamba2 serve loop: bad tokens")
    print(f"  serve batch=4 prompt=32 new=32 greedy: prefill "
          f"{st['prefill_s']:.3f}s, decode {st['decode_s']:.3f}s, "
          f"{st['tok_per_s']:.1f} tok/s, {st['decode_s'] / 32 * 1e3:.2f} "
          f"ms/step; launches {delta}")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del params
    torch.cuda.empty_cache()
    return counts


def prefill_jamba_period(dev):
    """Jamba at full width cut to one 8-layer period (mamba, mamba_moe,
    mamba, mamba_moe, attn_dense, mamba_moe, mamba, mamba_moe; 13.3B
    parameters, bf16: the whole 32 layers, ~104 GB, do not fit one card):
    two prefill calls at B=1, S=4096, each with 7 ssd_chunk_tc, 1 flash
    and 4 route-and-slot launches (0 router)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, init_ms = wall_ms(lambda: model.init_params(gen, cfg))
    n = n_params(params)
    print(f"  jamba-v0.1-52b, one period: {n} parameters ({cfg.dtype}), "
          f"schedule {cfg.block_schedule()}, init {init_ms / 1e3:.2f}s")
    if n != JAMBA_PERIOD_PARAMS:
        fail(f"jamba period parameter count {n}, expected "
             f"{JAMBA_PERIOD_PARAMS}")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 4096),
                                     generator=gen, device=dev)}
    times = prefill_launches(build_prefill_step(cfg), params, batch,
                             cfg.vocab_size, {"ssd_chunk_tc": 7,
                                              "flash_attention_tc": 1,
                                              "moe_route_slots": 4}, 2)
    print(f"  prefill B=1 S=4096: wall_ms={[round(x, 2) for x in times]} "
          f"(the first is a cold call) launches per call: 7 ssd_chunk_tc, 1 "
          f"tensor-core flash, 4 route-and-slot; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# [9] training the moe, ssm and hybrid families; expert parallelism
# ---------------------------------------------------------------------------

# (B, S) of the train steps: DeepSeekMoE (its route at T = 1,024, E = 64,
# k = 6), Mamba2-780M (its ssd_chunk_tc at [G, H, T, N, P] = [8, 48, 256,
# 128, 64]), the Jamba slice, and DeepSeekMoE through eplocal
MOE_TRAIN, MAMBA_TRAIN, JAMBA_TRAIN, EP_TRAIN = (2, 512), (2, 1024), \
    (1, 1024), (4, 256)
TRAIN_STEPS = 3
EP_MESH = (4, 2)                  # ("data", "model") on ["cuda:0"] * 8
# eplocal against grouped (no drops) and the replicated path against
# dense, in bf16: the expert outputs of each model shard are rounded to
# bf16 before the psum over "model" (the reference's order), where the
# one-device dispatch rounds the whole F sum once; each rounding is within
# u = 2**-8 of its value, and a partial may exceed the sum. Limit 8 u of
# the largest |y|.
EP_BF16_LIMIT = 2.0 ** -5


def grad_check(label, name, fn, plain, inputs, go, fwd_err):
    """The autograd Function of one kernel (``fn``, whose forward launches
    ``name`` once and whose backward recomputes a plain version) against
    ``plain``'s gradient at the same inputs. The backward is a plain
    version's own, so the check is of the plumbing (the saved inputs reach
    the recompute, the gradients come back in the inputs' layout); limit
    1e-6 of each gradient's max |.|. ``fwd_err(got, want)`` checks the
    forward. Times the kernel forward (no autograd), the Function's
    forward + recomputed backward and the plain forward + backward."""
    from repro_torch.kernels import ops

    def leaves():
        return [t.detach().clone().requires_grad_() for t in inputs]
    xs = leaves()
    before = dict(ops.LAUNCHES)
    out = fn(*xs)
    first = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(first, xs, go)
    grad_fn = type(first.grad_fn).__name__
    torch.cuda.synchronize()
    launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    if launched != {k: int(k == name) for k in ops.LAUNCHES}:
        fail(f"9 {label}: launches {launched}")
    ps = leaves()
    want = plain(*ps)
    pfirst = want[0] if isinstance(want, tuple) else want
    pgrads = torch.autograd.grad(pfirst, ps, go)
    with torch.no_grad():
        fwd_err(out, want)
    gerr = [float((g - p).abs().max()) for g, p in zip(grads, pgrads)]
    glim = [1e-6 * float(p.abs().max()) for p in pgrads]
    fwd_ms = device_ms(lambda: fn(*inputs))

    def both():
        x = leaves()
        o = fn(*x)
        torch.autograd.grad(o[0] if isinstance(o, tuple) else o, x, go)

    def plain_both():
        x = leaves()
        o = plain(*x)
        torch.autograd.grad(o[0] if isinstance(o, tuple) else o, x, go)
    both_ms, plain_ms = event_ms(both), event_ms(plain_both)
    print(f"  9 grad {label:40s} {grad_fn}: grad max_abs_err "
          f"{['%.2e' % e for e in gerr]} (limits "
          f"{['%.2e' % e for e in glim]}); kernel fwd {fwd_ms:.4f} ms, "
          f"fwd + recompute bwd {both_ms:.4f} ms (bwd "
          f"{both_ms - fwd_ms:.4f}), plain fwd + bwd {plain_ms:.4f} ms",
          flush=True)
    if not grad_fn.startswith("_") or any(not e <= lim for e, lim in
                                          zip(gerr, glim)):
        fail(f"9 {label}: grad_fn {grad_fn}, gradient errors {gerr} "
             f"(limits {glim})")
    return dict(fwd_ms=fwd_ms, bwd_ms=both_ms - fwd_ms, plain_ms=plain_ms)


def check_train_grads(dev):
    """The three kernels' autograd Functions at the shapes the training
    paths run: the route-and-slot kernel at DeepSeekMoE's train step (T =
    1,024, E = 64, k = 6, f32 logits, cap 120) and the router at the
    replicated eplocal path's T = 4,096, their gates' gradient against the
    plain version's (the same picks: idx equal); ssd_chunk_tc at
    Mamba2-780M's train step ([8, 48, 256, 128, 64], the model's layout),
    the gradients of all five inputs against the plain version's."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(91)
    out = {}
    for name, t in (("moe_route_slots", MOE_TRAIN[0] * MOE_TRAIN[1]),
                    ("moe_router", 4096)):
        logits, _ = router_rows(gen, t, 64, dev, torch.float32)
        go = torch.randn(t, 6, generator=gen, device=dev)
        if name == "moe_router":
            fn = lambda lg: ops.moe_router_topk(lg, 6)
            plain = lambda lg: ref.moe_router_topk_ref(lg, 6)
        else:
            cap = moe.grouped_capacity(t, 64, 6)
            fn = lambda lg: ops.moe_route_slots(lg, 6, cap)
            plain = lambda lg: ref.moe_route_slots_ref(lg, 6, cap)

        def fwd_err(got, want, name=name):
            if not torch.equal(got[1], want[1]) or float(
                    (got[0] - want[0]).abs().max()) > 1e-6:
                fail(f"9 grad {name}: picks or gates differ from the plain "
                     f"version's")
        out[name] = grad_check(f"{name} T={t} E=64 k=6 f32", name, fn,
                               plain, (logits,), go, fwd_err)
    tag, b, s, h, n, p, chunk = ("mamba2-780m train", *MAMBA_TRAIN, 48, 128,
                                 64, 256)
    args = ssd_inputs(gen, b, s, h, n, p, chunk, dev)
    go = torch.randn(args[4].shape, generator=gen, device=dev)

    def ssd_err(got, want):
        lim = 1e-5 * float(want.abs().max())
        if not float((got - want).abs().max()) <= lim:
            fail("9 grad ssd_chunk_tc: forward beyond 1e-5 max|y|")
    g = args[4].shape[0]
    out["ssd_chunk_tc"] = grad_check(
        f"ssd_chunk_tc {tag} [{g}, {h}, {chunk}, {n}, {p}]",
        "ssd_chunk_tc", ops.ssd_chunk, ref.ssd_chunk_ref, args, go, ssd_err)
    return out


def grad_norm(grads) -> torch.Tensor:
    from repro_torch.core import pods
    return torch.sqrt(sum(g.float().square().sum()
                          for g in pods.flatten(grads).values()))


def train_steps(label, cfg, params, opt, shape, want, moe_strategy="grouped",
                steps=TRAIN_STEPS):
    """``steps`` ``build_train_step`` steps on the card from ``params`` on
    a batch of random tokens and labels of ``shape``: each step's loss and
    gradient norm finite, exactly ``want`` kernel launches a step (the
    forward's, and again those of every scanned layer under ``remat``,
    whose checkpoint recomputes its forward in the backward; the
    Functions' recomputed plain backwards launch none; 0 for the
    others).
    Prints the losses, norms, ms a step and peak memory; returns (the
    params, the launches of the run)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    gen = torch.Generator(device=params["embedding"].device)
    gen.manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=gen,
                              device=params["embedding"].device)
             for k in ("tokens", "labels")}
    norms = []

    def update(p, g, st, step):
        norms.append(grad_norm(g))
        return opt.update(p, g, st, step)
    step_fn = build_train_step(cfg, dataclasses.replace(opt, update=update),
                               moe_strategy=moe_strategy)
    state = opt.init(params)
    losses, times = [], []
    ops.reset_launches()
    for i in range(steps):
        before = dict(ops.LAUNCHES)
        (params, state, _, loss), ms = wall_ms(
            lambda: step_fn(params, state, i, batch))
        delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        if delta != {k: want.get(k, 0) for k in ops.LAUNCHES}:
            fail(f"9 train {label}: launches {delta}, expected {want}")
        losses.append(float(loss))
        times.append(ms)
    counts = dict(ops.LAUNCHES)
    norms = [float(x) for x in norms]
    print(f"  9 train {label}: {opt.name} B={shape[0]} S={shape[1]} losses "
          f"{[round(x, 4) for x in losses]} grad norms "
          f"{['%.3e' % x for x in norms]} ms a step "
          f"{[round(x, 2) for x in times]} (the first cold); launches a "
          f"step {want}; peak {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB", flush=True)
    if not np.isfinite(losses + norms).all():
        fail(f"9 train {label}: losses {losses}, norms {norms}")
    del state
    return params, counts


def kernels_per_call(fn) -> int:
    """Device operations (kernels, copies, sets) of one call, from
    torch.profiler, after a warm-up call; 0 where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def median_ms(fn, calls=5):
    fn()
    return statistics.median(wall_ms(fn)[1] for _ in range(calls))


def ep_close(label, got, want):
    err = float((got.float() - want.float()).abs().max())
    lim = EP_BF16_LIMIT * float(want.float().abs().max())
    print(f"  9 {label}: max|y|={float(want.float().abs().max()):.3e} "
          f"max_abs_err={err:.3e} err/limit={err / lim:.3f}", flush=True)
    if not bool(torch.isfinite(got).all()) or not err <= lim:
        fail(f"9 {label}: {err} beyond {lim}")


def expert_parallel_layer(dev, cfg, moe_p):
    """One full-width DeepSeekMoE MoE layer (bf16) on the (4, 2) mesh
    ``["cuda:0"] * 8``: ``eplocal`` at B = 4, S = 512 against ``grouped``,
    both at ``cap_factor=8.0``, where no pair drops (checked: every
    expert's count within both capacities), within ``EP_BF16_LIMIT``, aux
    within 1e-5; ``eplocal_fp8`` with its dispatch bytes beside the bf16
    dispatch's (``moe_eplocal.EXCHANGE``); the replicated path at B = 1, S
    = 4,096 against ``dense``. Launches: 4 route-and-slot a call on the
    all_to_all path, 1 router on the replicated one. ms and device
    operations a call of each beside the one-device dispatch's. Returns
    the launches of these calls."""
    from repro_torch import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import moe, moe_eplocal
    ep, tp = EP_MESH
    mesh = sharding.make_mesh(EP_MESH, ("data", "model"), ["cuda:0"] * 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    d, e, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    dtype = getattr(torch, cfg.dtype)
    x = torch.randn(4, 512, d, generator=gen, device=dev).to(dtype)
    x1 = torch.randn(1, 4096, d, generator=gen, device=dev).to(dtype)
    counts = {name: 0 for name in ops.LAUNCHES}

    def counted(fn, want):
        before = dict(ops.LAUNCHES)
        out = fn()
        delta = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        if delta != {n: want.get(n, 0) for n in ops.LAUNCHES}:
            fail(f"9 eplocal: launches {delta}, expected {want}")
        for n in delta:
            counts[n] += delta[n]
        return out

    with torch.no_grad(), sharding.logical_rules(mesh, {}):
        # no drops: each expert's pairs within both capacities
        idx = ops.moe_router_topk(moe.router_logits(moe_p, x.view(-1, d)),
                                  k)[1].long().view(ep, -1)
        per_shard = max(int(torch.bincount(r, minlength=e).max())
                        for r in idx)
        whole = int(torch.bincount(idx.view(-1), minlength=e).max())
        cap_ep = moe.grouped_capacity(512, e, k, 8.0)
        cap_g = moe.grouped_capacity(4 * 512, e, k, 8.0)
        if per_shard > cap_ep or whole > cap_g:
            fail(f"9 eplocal: pairs drop ({per_shard} > {cap_ep} or "
                 f"{whole} > {cap_g})")
        ops.reset_launches()
        moe_eplocal.reset_exchange()
        y_ep, aux_ep = counted(lambda: moe_eplocal.moe_eplocal(
            moe_p, cfg, x, cap_factor=8.0), {"moe_route_slots": ep})
        bf16_bytes = dict(moe_eplocal.EXCHANGE)
        y_g, aux_g = moe.moe_grouped(moe_p, cfg, x.view(-1, d),
                                     capacity_factor=8.0)
        ep_close(f"eplocal vs grouped B=4 S=512 cap_factor=8 (most per "
                 f"expert: {per_shard} of {cap_ep} a shard, {whole} of "
                 f"{cap_g})", y_ep, y_g.view(x.shape))
        if not abs(float(aux_ep) - float(aux_g)) <= 1e-5:
            fail(f"9 eplocal aux {float(aux_ep)} vs grouped "
                 f"{float(aux_g)}")
        moe_eplocal.reset_exchange()
        y_f8, _ = counted(lambda: moe_eplocal.moe_eplocal(
            moe_p, cfg, x, cap_factor=8.0, a2a_fp8=True),
            {"moe_route_slots": ep})
        fp8_bytes = dict(moe_eplocal.EXCHANGE)
        f8_err = float((y_f8.float() - y_ep.float()).abs().max())
        print(f"  9 eplocal_fp8: dispatch bytes {fp8_bytes['dispatch']} "
              f"vs bf16 {bf16_bytes['dispatch']} (ratio "
              f"{fp8_bytes['dispatch'] / bf16_bytes['dispatch']:.4f}); "
              f"combine bytes {fp8_bytes['combine']} (bf16 "
              f"{bf16_bytes['combine']}); max |y_fp8 - y_bf16| = "
              f"{f8_err:.3e}", flush=True)
        if not bool(torch.isfinite(y_f8).all()) or \
                not fp8_bytes["dispatch"] < 0.52 * bf16_bytes["dispatch"]:
            fail("9 eplocal_fp8: not finite or not about half the bytes")
        y_rep, aux_rep = counted(lambda: moe_eplocal.moe_eplocal(
            moe_p, cfg, x1), {"moe_router": 1})
        y_d, aux_d = moe.moe_dense(moe_p, cfg, x1.view(-1, d))
        ep_close("eplocal replicated B=1 S=4096 vs dense", y_rep,
                 y_d.view(x1.shape))
        if not abs(float(aux_rep) - float(aux_d)) <= 1e-5:
            fail(f"9 eplocal replicated aux {float(aux_rep)} vs "
                 f"{float(aux_d)}")
        for label, fn, one in (
                ("B=4 S=512", lambda: moe_eplocal.moe_eplocal(
                    moe_p, cfg, x), lambda: moe.moe_grouped(
                        moe_p, cfg, x.view(-1, d))),
                ("B=4 S=512 fp8", lambda: moe_eplocal.moe_eplocal(
                    moe_p, cfg, x, a2a_fp8=True), None),
                ("B=1 S=4096 replicated", lambda: moe_eplocal.moe_eplocal(
                    moe_p, cfg, x1), lambda: moe.moe_dense(
                        moe_p, cfg, x1.view(-1, d)))):
            ep_ms, ep_ops = median_ms(fn), kernels_per_call(fn)
            line = (f"  9 eplocal {label}: {ep_ms:.3f} ms, {ep_ops} device "
                    f"operations a call")
            if one is not None:
                line += (f"; one device ({'grouped' if 'S=512' in label else 'dense'}): "
                         f"{median_ms(one):.3f} ms, {kernels_per_call(one)} "
                         f"device operations")
            print(line, flush=True)
    return counts


def reduced_eplocal_card_vs_cpu(dev):
    """The reduced DeepSeekMoE (f32) loss and gradient through ``eplocal``
    on the (4, 2) mesh, on the card (``["cuda:0"] * 8``) and on the CPU
    (``["cpu"] * 8``), from one set of parameters and tokens: the loss
    within 1e-4, every gradient leaf within 1e-4 of its max |.|. Returns
    the card's launches."""
    from repro_torch import sharding
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.core import pods
    from repro_torch.kernels import ops
    from repro_torch.models import model
    cfg = reduced(get_config("deepseek-moe-16b"))
    gen = torch.Generator()
    gen.manual_seed(23)
    params = model.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 4, 16), generator=gen)
    out = {}
    for where in ("cpu", dev):
        flat = {k: v.to(where).requires_grad_()
                for k, v in pods.flatten(params).items()}
        batch = {"tokens": toks[0].to(where), "labels": toks[1].to(where)}
        mesh = sharding.make_mesh(EP_MESH, ("data", "model"),
                                  [where] * 8)
        ops.reset_launches()
        with sharding.logical_rules(mesh, {}):
            loss, _ = model.loss_fn(pods.rebuild(params, flat), cfg, batch,
                                    moe_strategy="eplocal")
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True)
        out[str(where)] = (float(loss.detach()), [
            torch.zeros_like(v) if g is None else g.cpu()
            for v, g in zip(flat.values(), grads)], dict(ops.LAUNCHES))
    (lc, gc, _), (lg, gg, launched) = out["cpu"], out[str(dev)]
    gerr = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(gg, gc))
    print(f"  9 reduced deepseek-moe f32 eplocal card vs CPU: loss "
          f"{lg:.6f} vs {lc:.6f} (diff {abs(lg - lc):.2e}), worst gradient "
          f"err / its max {gerr:.2e}; card launches "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    if not abs(lg - lc) <= 1e-4 or not gerr <= 1e-4 or \
            launched["moe_route_slots"] != EP_MESH[0]:
        fail("9 reduced eplocal card vs CPU")
    return launched


def train_and_expert_parallel(dev):
    """Phase [9]; returns {kernel: launches of the training and
    expert-parallel runs} and the gradient checks' times."""
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer
    launches = {}

    def flash(cfg):
        return ops.flash_kernel(getattr(torch, cfg.dtype), cfg.head_dim)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    grad_times = check_train_grads(dev)
    # DeepSeekMoE-16B cut to its dense first layer and three MoE layers
    # (2.27B parameters: with Adam's fp32 moments, old and new side by
    # side in an update, ~50 GB)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=4)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen, cfg)
    print(f"  9 deepseek-moe-16b cut to {cfg.num_layers} layers "
          f"{cfg.block_schedule()}: {n_params(params)} parameters",
          flush=True)
    params, counts = train_steps(
        "deepseek-moe-16b (grouped)", cfg, params,
        make_optimizer("adam", 1e-4), MOE_TRAIN,
        {flash(cfg): 4 + 3, "moe_route_slots": 3 + 3})
    add(counts)
    # the first MoE layer (views of the stacked leaves of a scanned stack)
    moe_p = {k: v[0] for k, v in params["scan"]["0"]["moe"].items()} \
        if cfg.scan_layers else params["layers"]["1"]["moe"]
    add(expert_parallel_layer(dev, cfg, moe_p))
    del moe_p
    mesh = sharding.make_mesh(EP_MESH, ("data", "model"), ["cuda:0"] * 8)
    with sharding.logical_rules(mesh, {}):
        params, counts = train_steps(
            "deepseek-moe-16b (eplocal, 4 x 2 on one card)", cfg, params,
            make_optimizer("sgd", 1e-3), EP_TRAIN,
            {flash(cfg): 4 + 3, "moe_route_slots": 2 * 3 * EP_MESH[0]},
            moe_strategy="eplocal", steps=1)
    add(counts)
    del params
    torch.cuda.empty_cache()

    cfg = get_config("mamba2-780m")
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(gen, cfg)
    if n_params(params) != MAMBA2_PARAMS:
        fail("9 mamba2-780m parameter count")
    params, counts = train_steps("mamba2-780m (whole)", cfg, params,
                                 make_optimizer("adam", 1e-4), MAMBA_TRAIN,
                                 {"ssd_chunk_tc": 2 * cfg.num_layers})
    add(counts)
    del params
    torch.cuda.empty_cache()

    # Jamba's first five layers: mamba, mamba_moe, mamba, mamba_moe,
    # attn_dense (7.15B parameters; Adam's moments would need ~115 GB more)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=5)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(gen, cfg)
    sched = cfg.block_schedule()
    print(f"  9 jamba-v0.1-52b cut to {cfg.num_layers} layers {sched}: "
          f"{n_params(params)} parameters", flush=True)
    params, counts = train_steps(
        "jamba-v0.1-52b slice", cfg, params, make_optimizer("sgd", 1e-3),
        JAMBA_TRAIN, {"ssd_chunk_tc": sum(s.startswith("mamba")
                                          for s in sched),
                      flash(cfg): sum(s.startswith("attn") for s in sched),
                      "moe_route_slots": sum(s.endswith("moe")
                                             for s in sched)})
    add(counts)
    del params
    torch.cuda.empty_cache()
    add(reduced_eplocal_card_vs_cpu(dev))
    return launches, grad_times


# ---------------------------------------------------------------------------
# [10] launch costing: the dry run's counts against the card's
# ---------------------------------------------------------------------------

# (arch, shape, cut batch, cut length): each pair of the dry run at a cut
# that fits the card (0 keeps the shape's length). DeepSeekMoE's batch of
# 1 takes expert parallelism's replicated path (the router kernel); its
# batch of 8 at a cut length the all_to_all path (route-and-slot)
COSTING_PAIRS = (("qwen3-0.6b", "train_4k", 2, 0),
                 ("deepseek-moe-16b", "prefill_32k", 1, 0),
                 ("deepseek-moe-16b", "prefill_32k", 8, 4096),
                 ("mamba2-780m", "prefill_32k", 1, 0))
# the measured peak against the meta count: allocator rounding and
# library workspaces (cuBLAS) are not tensors
PEAK_MARGIN, PEAK_FLOOR = 0.10, 256e6


def launch_costing(dev):
    """Phase [10]: each pair of ``COSTING_PAIRS`` through
    ``dryrun.measure`` (its policies: Adam and remat for the train pair,
    ``eplocal`` for the MoE, whose batch of 1 takes the replicated path; the
    production pod's ("data", "model") = (2, 4) mesh of ``dev`` repeated,
    the state placed and the steps tensor-parallel): the counted
    flops, bytes and kernel calls on the card equal the meta count's at
    the same cut, the launches equal the counted calls (and are above
    zero), and the measured peak (``max_memory_allocated`` less what
    stood before the pair's state) lies within ``PEAK_MARGIN`` or
    ``PEAK_FLOOR`` of the meta peak. Prints each pair's counts, the peak
    gap, the step's ms and the roofline share; returns {kernel:
    launches}."""
    from repro_torch.launch import dryrun
    launches = {}
    for arch, shape, batch, seq in COSTING_PAIRS:
        r = dryrun.measure(arch, shape, batch=batch, seq=seq, device=dev,
                           repeats=2)
        m, d = r["meta"], r["device"]
        label = f"10 {arch} {shape} ({', '.join(r['cuts']) or 'uncut'})"
        if (m["flops"], m["bytes"], m["calls"]) != \
                (d["flops"], d["bytes"], d["calls"]):
            fail(f"{label}: card counts {d} differ from meta's {m}; ops "
                 f"(meta, card) that differ: {r['ops_gap']}")
        if r["launches"] != d["calls"] or not sum(r["launches"].values()):
            fail(f"{label}: launches {r['launches']} against counted calls "
                 f"{d['calls']}")
        gap = r["measured_peak_bytes"] - m["peak_bytes"]
        limit = max(PEAK_MARGIN * m["peak_bytes"], PEAK_FLOOR)
        print(f"  {label}: {r['optimizer']}, {r['moe_strategy']}, remat "
              f"{r['remat']}; flops {d['flops']:.6e}, bytes "
              f"{d['bytes']:.6e} (card = meta); launches {r['launches']} "
              f"= counted calls; peak meta {m['peak_bytes'] / 1e9:.3f} GB, "
              f"measured {r['measured_peak_bytes'] / 1e9:.3f} GB, gap "
              f"{gap / 1e9:+.3f} GB (limit {limit / 1e9:.3f}); step "
              f"{r['step_ms']:.2f} ms "
              f"{[round(t, 2) for t in r['step_ms_all']]}; roofline "
              f"{r['roofline_ms']:.3f} ms, share "
              f"{r['roofline_share']:.4f}; meta count {m['seconds']:.1f} s; "
              f"{card_line()}", flush=True)
        if abs(gap) > limit:
            fail(f"{label}: measured peak {r['measured_peak_bytes']} B, "
                 f"meta {m['peak_bytes']} B: gap beyond {limit:.0f} B")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# [11] tensor parallelism inside a pod
# ---------------------------------------------------------------------------

TP_REDUCED = ("qwen3-0.6b", "granite-20b", "mamba2-780m", "deepseek-moe-16b",
              "whisper-tiny")
TP_SHAPES = ((2, 2), (2, 4))


def tp_mesh(dev, shape):
    from repro_torch import sharding
    return sharding.make_mesh(shape, ("data", "model"),
                              [str(dev)] * (shape[0] * shape[1]))


def tp_run(cfg, params, batch, mesh, rules, strategy, placed, steps=8):
    """One model's logits, loss, gradients (a flat dict) and ``steps``
    greedy decode steps (logits, tokens), placed on ``mesh`` or whole;
    with the kernel launches of its first forward."""
    from repro_torch import sharding
    from repro_torch.core import pods as pods_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model
    dev = batch["tokens"].device
    b = batch["tokens"].shape[0]
    with sharding.logical_rules(mesh, rules):
        tree = model.place_params(params, cfg, mesh, rules) if placed \
            else params
        before = dict(ops.LAUNCHES)
        with torch.no_grad():
            logits, _ = model.forward(tree, cfg, batch,
                                      moe_strategy=strategy)
        torch.cuda.synchronize()
        fwd = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES
               if ops.LAUNCHES[k] != before[k]}
        if placed:
            loss, g = steps_mod.placed_grads(cfg, tree, batch, strategy)
            grads = pods_mod.flatten(sharding.unplace(g))
        else:
            leaves = {k: v.detach().requires_grad_()
                      for k, v in pods_mod.flatten(params).items()}
            loss, _ = model.loss_fn(pods_mod.rebuild(params, leaves), cfg,
                                    batch, moe_strategy=strategy)
            gl = torch.autograd.grad(loss, list(leaves.values()))
            loss = loss.detach()
            grads = dict(zip(leaves, gl))
        with torch.no_grad():
            cache = model.init_cache(cfg, b, steps, device=dev)
            if placed:
                cache = model.place_cache(cache, cfg, mesh, rules)
            enc = model.encode(tree, cfg, batch["frame_embeds"]) \
                if cfg.is_encoder_decoder else None
            tok = batch["tokens"][:, :1]
            dec = []
            for pos in range(steps):
                lg, cache = model.decode_step(tree, cfg, tok, cache, pos,
                                              enc_out=enc)
                tok = lg.argmax(dim=-1)
                dec.append((lg, tok))
    return logits, float(loss), grads, dec, fwd


def tp_reduced_card(dev):
    """The reduced f32 models of ``TP_REDUCED`` placed on (2, 2) and
    (2, 4) meshes of ``dev`` repeated against the same model unsharded on
    the card (eplocal against eplocal on the whole tree): logits and loss
    within 1e-5, gradients within 1e-4 of their max, 8 decode steps'
    logits within 2e-3 and equal tokens; a forward launches flash (or
    ssd_chunk_tc) attention layers x tp times. Returns the launches."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding_rules import base_rules
    from repro_torch.models import model
    rules = base_rules(False)
    total = {}
    for arch in TP_REDUCED:
        cfg = reduced(get_config(arch))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init_params(gen, cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                         generator=gen, device=dev)}
        batch["labels"] = batch["tokens"]
        if cfg.is_encoder_decoder:
            batch["frame_embeds"] = torch.randn(
                (2, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                device=dev)
        strategy = "eplocal" if cfg.moe else "grouped"
        attn = sum(k in ("attn_dense", "attn_moe")
                   for k in cfg.block_schedule())
        if cfg.is_encoder_decoder:
            attn = 2 * attn + cfg.num_encoder_layers
        ssd = cfg.num_layers - sum(k in ("attn_dense", "attn_moe")
                                   for k in cfg.block_schedule())
        for shape in TP_SHAPES:
            mesh = tp_mesh(dev, shape)
            want = tp_run(cfg, params, batch, mesh, rules, strategy, False)
            got = tp_run(cfg, params, batch, mesh, rules, strategy, True)
            tp = shape[1]
            err = float((got[0] - want[0]).abs().max())
            lerr = abs(got[1] - want[1])
            top = max(float(g.abs().max()) for g in want[2].values())
            gerr = max(float((got[2][k] - want[2][k]).abs().max())
                       for k in want[2])
            derr = max(float((a[0] - b[0]).abs().max())
                       for a, b in zip(got[3], want[3]))
            same = all(torch.equal(a[1], b[1]) for a, b in zip(got[3],
                                                              want[3]))
            flash = got[4].get("flash_attention", 0) + \
                got[4].get("flash_attention_tc", 0)
            ssd_n = got[4].get("ssd_chunk_tc", 0)
            print(f"  11 {cfg.name} tp {shape}: logits {err:.3e} (tol "
                  f"1e-5), loss {lerr:.3e} (1e-5), grads {gerr:.3e} / max "
                  f"{top:.3e} (1e-4 of it), decode {derr:.3e} (2e-3), "
                  f"tokens equal {same}; forward launches {got[4]} "
                  f"(unsharded {want[4]}); {card_line()}", flush=True)
            if not (err <= 1e-5 and lerr <= 1e-5 and gerr <= 1e-4 * top
                    and derr <= 2e-3 and same):
                fail(f"11 {cfg.name} {shape}: tensor-parallel and "
                     f"unsharded disagree")
            if flash != attn * tp or ssd_n != ssd * tp:
                fail(f"11 {cfg.name} {shape}: forward launches {got[4]}, "
                     f"expected flash {attn} x {tp}, ssd {ssd} x {tp}")
            for k, v in got[4].items():
                total[k] = total.get(k, 0) + v
            torch.cuda.empty_cache()
    return total


# [11]'s full-width limits. f32 prefill logits: the CPU tests' 1e-5 (read
# on an H100: 2.98e-6). The bf16 train step, placed against unsharded,
# each leaf's worst |difference| over its largest |value|: the loss
# before the update within 2e-2; Adam's moments m (0.1 g) and v (0.001
# g^2) carry the bf16 gradients' rounding (read: 3.39e-2 and 6.90e-2), the
# new parameters a bf16 step each (read: 4.18e-3, under 2**-6, two ulps of
# the largest); ``TRAIN_UPDATE_LIMIT`` bounds sum |dp - du| / sum |du| of
# each leaf's update (read: 2.09e-2; a leaf updated wrongly or not at all
# reads ~1). A wrong gradient moves m and v by their own size.
TP_LOGITS_LIMIT = 1e-5
TRAIN_STATE_LIMITS = {"params": 2.0 ** -6, "m": 1e-1, "v": 2e-1}
TRAIN_UPDATE_LIMIT = 0.1


def leaf_gap(a: dict, b: dict) -> float:
    """Worst leaf of max |a - b| / max |b| over two flat dicts."""
    worst = 0.0
    for k, want in b.items():
        want = want.float()
        diff = float((a[k].float() - want).abs().max())
        top = float(want.abs().max())
        worst = max(worst, diff / top if top else diff)
    return worst


def update_gap(new_a: dict, new_b: dict, old: dict) -> float:
    """Worst leaf of sum |(a - old) - (b - old)| / sum |b - old|."""
    worst = 0.0
    for k, o in old.items():
        du = new_b[k].float() - o.float()
        num = float((new_a[k].float() - o.float() - du).abs().sum())
        den = float(du.abs().sum())
        worst = max(worst, num / den if den else num)
    return worst


def tp_full_width(dev):
    """Full-width qwen3-0.6b on the (2, 4) mesh of ``dev`` repeated: f32
    prefill (B = 2, S = 128) and 8 greedy decode steps against unsharded
    (prefill logits within ``TP_LOGITS_LIMIT``, tokens equal, decode logits
    within 2e-3), launches 28 x 4 SIMT flash per prefill; one bf16 train
    step (Adam, remat, B = 2, S = 512) beside the unsharded one:
    tensor-core flash 2 x 28 x 4, the loss, the new parameters and Adam's
    moments within ``TRAIN_STATE_LIMITS`` and each leaf's update within
    ``TRAIN_UPDATE_LIMIT``. Each runs twice in the order unsharded, placed,
    unsharded, placed; the second run's ms and peaks are printed. Returns
    the launches of the second placed runs."""
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.core import pods as pods_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.sharding_rules import base_rules
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer
    rules = base_rules(False)
    mesh = tp_mesh(dev, (2, 4))
    total = {}
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device=dev)
    runs = {}
    # unsharded, placed, then both again: the second of each is kept (the
    # first calls pay the library's first-use costs)
    for placed in (False, True, False, True):
        with sharding.logical_rules(mesh, rules), torch.no_grad():
            tree = model.place_params(params, cfg, mesh, rules) if placed \
                else params
            before = dict(ops.LAUNCHES)
            logits, ms = wall_ms(lambda: model.forward(tree, cfg, {
                "tokens": tokens})[0])
            launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES
                        if ops.LAUNCHES[k] != before[k]}
            cache = model.init_cache(cfg, 2, 8, device=dev)
            if placed:
                cache = model.place_cache(cache, cfg, mesh, rules)
            tok, dec = tokens[:, :1], []
            t0 = time.perf_counter()
            for pos in range(8):
                lg, cache = model.decode_step(tree, cfg, tok, cache, pos)
                tok = lg.argmax(dim=-1)
                dec.append((lg, tok))
            torch.cuda.synchronize()
            dms = (time.perf_counter() - t0) * 1e3 / 8
        runs[placed] = (logits, dec, ms, dms, launched)
        del tree
    (la, da, ma, dma, ka), (lb, db, mb, dmb, kb) = runs[False], runs[True]
    err = float((la - lb).abs().max())
    derr = max(float((a[0] - b[0]).abs().max()) for a, b in zip(da, db))
    same = all(torch.equal(a[1], b[1]) for a, b in zip(da, db))
    print(f"  11 qwen3-0.6b f32 full width (2, 4): prefill B=2 S=128 "
          f"{mb:.2f} ms (unsharded {ma:.2f}), launches {kb} (unsharded "
          f"{ka}); logits {err:.3e}; decode {dmb:.2f} ms a step (unsharded "
          f"{dma:.2f}), logits {derr:.3e} (tol 2e-3), tokens equal {same}; "
          f"{card_line()}", flush=True)
    if kb.get("flash_attention") != 28 * 4 or not same or derr > 2e-3 \
            or not err <= TP_LOGITS_LIMIT:
        fail(f"11 qwen3-0.6b full width: launches {kb} (expected 112 SIMT "
             f"flash), prefill logits {err} (limit {TP_LOGITS_LIMIT}) or "
             f"decode disagrees")
    for k, v in kb.items():
        total[k] = total.get(k, 0) + v
    del params, runs
    torch.cuda.empty_cache()

    cfg = get_config("qwen3-0.6b")
    gen.manual_seed(0)
    params = model.init_params(gen, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                     generator=gen, device=dev)}
    batch["labels"] = batch["tokens"]
    opt = make_optimizer("adam", 1e-4)
    step0 = torch.zeros((), dtype=torch.int64, device=dev)
    out = {}
    for placed in (False, True, False, True):
        with sharding.logical_rules(mesh, rules):
            state = opt.init(params)
            tree = params
            if placed:
                tree, state = steps_mod.place_state(cfg, params, state,
                                                    "adam", mesh, rules)
            step = steps_mod.build_train_step(cfg, opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = dict(ops.LAUNCHES)
            res, ms = wall_ms(lambda: step(tree, state, step0, batch))
            launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES
                        if ops.LAUNCHES[k] != before[k]}
            peak = torch.cuda.max_memory_allocated(dev)
            new_p, new_s = res[0], res[1]
            if placed:
                new_p, new_s = sharding.unplace(new_p), sharding.unplace(new_s)
            out[placed] = (float(res[3]), ms, launched, peak, {
                "params": pods_mod.flatten(new_p),
                "m": pods_mod.flatten(new_s["m"]),
                "v": pods_mod.flatten(new_s["v"])})
            del res, tree, state, new_p, new_s
        torch.cuda.empty_cache()
    (l0, m0, k0, p0, s0), (l1, m1, k1, p1, s1) = out[False], out[True]
    gaps = {k: leaf_gap(s1[k], s0[k]) for k in TRAIN_STATE_LIMITS}
    upd = update_gap(s1["params"], s0["params"], pods_mod.flatten(params))
    print(f"  11 qwen3-0.6b bf16 train step (2, 4), Adam, remat, B=2 "
          f"S=512: loss {l1:.5f} (unsharded {l0:.5f}), {m1:.1f} ms "
          f"(unsharded {m0:.1f}), peak {p1 / 1e9:.3f} GB (unsharded "
          f"{p0 / 1e9:.3f}), launches {k1} (unsharded {k0}); after the "
          f"step, worst leaf gap / its max: "
          + ", ".join(f"{k} {v:.3e} (limit {TRAIN_STATE_LIMITS[k]:.3e})"
                      for k, v in gaps.items())
          + f"; update gap {upd:.3e} (limit {TRAIN_UPDATE_LIMIT}); "
          f"{card_line()}", flush=True)
    if not (np.isfinite(l1) and abs(l1 - l0) <= 2e-2) or \
            k1.get("flash_attention_tc") != 2 * 28 * 4 or \
            any(not gaps[k] <= TRAIN_STATE_LIMITS[k] for k in gaps) or \
            not upd <= TRAIN_UPDATE_LIMIT:
        fail(f"11 qwen3-0.6b bf16 train step: loss {l1} against {l0}, "
             f"launches {k1}, state gaps {gaps}, update gap {upd}")
    for k, v in k1.items():
        total[k] = total.get(k, 0) + v
    return total


def tensor_parallel(dev):
    """Phase [11] (see the module docstring). Returns the launches."""
    total = tp_reduced_card(dev)
    for k, v in tp_full_width(dev).items():
        total[k] = total.get(k, 0) + v
    return total


@contextlib.contextmanager
def launched_shapes(seen: set):
    """Adds to ``seen`` the shape key (``flash_key``, ``ssd_key``) of every
    ``ops.flash_attention`` and ``ops.ssd_chunk`` call made while active:
    the model code calls both through the ``ops`` module."""
    from repro_torch.kernels import ops
    flash, ssd = ops.flash_attention, ops.ssd_chunk

    def flash_seen(q, k, v, *, causal=True, window=0):
        seen.add(flash_key(q, k, causal, window))
        return flash(q, k, v, causal=causal, window=window)

    def ssd_seen(*args):
        seen.add(ssd_key(args))
        return ssd(*args)
    ops.flash_attention, ops.ssd_chunk = flash_seen, ssd_seen
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_chunk = flash, ssd


@contextlib.contextmanager
def launched_kernel_shapes(seen: set):
    """``launched_shapes``, and the shape key (``gossip_key``,
    ``router_key``) of every gossip mix and ``ops.moe_router_topk`` call
    made while active (the round programs and the benches call them
    through the ``ops`` module)."""
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in GOSSIP + ("moe_router_topk",)}

    def mix(P, w):
        seen.add(gossip_key("gossip_mix", None, w))
        return saved["gossip_mix"](P, w)

    def sparse(idx, val, w):
        seen.add(gossip_key("gossip_mix_sparse", idx, w))
        return saved["gossip_mix_sparse"](idx, val, w)

    def quant(idx, val, scale, q):
        seen.add(gossip_key("gossip_mix_quant", idx, q))
        return saved["gossip_mix_quant"](idx, val, scale, q)

    def router(logits, k):
        seen.add(router_key(logits, k))
        return saved["moe_router_topk"](logits, k)
    ops.gossip_mix, ops.gossip_mix_sparse, ops.gossip_mix_quant = \
        mix, sparse, quant
    ops.moe_router_topk = router
    try:
        with launched_shapes(seen):
            yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def csr_world(w: int, k: int, seed: int, dev):
    """idx [W, K] int32, val [W, K] f32 of a padded-CSR mix with K slots:
    slot 0 the row itself, the rest random rows, the last slot a pad (val
    0) where K > 1; weights positive, each row summing to 1."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, w, size=(w, k)).astype(np.int32)
    idx[:, 0] = np.arange(w)
    val = rng.uniform(0.5, 1.5, size=(w, k))
    if k > 1:
        val[:, -1] = 0.0
    val /= val.sum(1, keepdims=True)
    return (torch.tensor(idx, device=dev),
            torch.tensor(val, dtype=torch.float32, device=dev))


def gossip_case(gen, key, dev):
    """A gossip mix at a shape key (``gossip_key``) on fresh inputs against
    its plain version: a random row-stochastic P (dense) or ``csr_world``,
    a payload of the key's dtype (int8: quantized rows with their
    scales); one launch; limit 1e-5 (1 + max|plain|). Returns the
    error."""
    from repro_torch.kernels import ops, ref
    name, dtype, w = key[:3]
    f = key[-1]
    w_in, scale = payload(gen, w, f, dtype)
    if name == "gossip_mix":
        P = torch.rand(w, w, generator=gen, device=dev)
        P = (P / P.sum(1, keepdim=True)).contiguous()
        kern = lambda: ops.gossip_mix(P, w_in)              # noqa: E731
        plain = lambda: ref.gossip_mix_ref(P, w_in)         # noqa: E731
    else:
        idx, val = csr_world(w, key[3], seed=w + f, dev=dev)
        if name == "gossip_mix_quant":
            kern = lambda: ops.gossip_mix_quant(idx, val, scale,  # noqa
                                                w_in)
            plain = lambda: ref.gossip_mix_quant_ref(idx, val,  # noqa
                                                     scale, w_in)
        else:
            kern = lambda: ops.gossip_mix_sparse(idx, val, w_in)  # noqa
            plain = lambda: ref.gossip_mix_sparse_ref(idx, val,  # noqa
                                                      w_in)
    before = ops.LAUNCHES[name]
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    err = float((got - want).abs().max())
    tol = 1e-5 * (1.0 + float(want.abs().max()))
    print(f"  check {name:18s} {list(key[2:])} {dtype:8s} max_abs_err="
          f"{err:.3e} tol={tol:.1e}")
    if ops.LAUNCHES[name] - before != 1 or got.shape != want.shape \
            or not err <= tol:
        fail(f"{name} at {key} disagrees with its plain version")
    CHECKED.add(key)
    return err


def check_launched_shapes(dev, seen: set, max_err: dict,
                          phases="[10]/[11]"):
    """Holds every shape in ``seen`` that [2] did not check against its
    plain version, on fresh inputs in the model's layout (flash: views of
    [B, S, H, D] tensors; ssd_chunk: ``ssd_inputs``; the gossip mixes:
    ``gossip_case``; the router: ``router_case``); raises ``max_err``'s
    entries where these are worse."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    new = sorted(seen - CHECKED, key=str)
    print(f"  {len(seen)} shapes launched, {len(seen) - len(new)} of them "
          f"checked in [2]; checking {len(new)}: {new}", flush=True)
    for key in new:
        if key[0] == "flash":
            _, dtype, b, h, sq, d, sk, causal, window = key
            dtype = getattr(torch, dtype)
            if sk == sq:
                qkv = main_path_qkv(gen, b, sq, dev, h, dtype, d)
            else:
                qkv = cross_qkv(gen, b, h, sq, sk, d, dev, dtype)
            name, err, _ = flash_case(f"launched in {phases}", *qkv,
                                      causal, window)
            max_err[name] = max(max_err[name], err)
        elif key[0] == "ssd":
            _, g, h, t, n, p = key
            args = ssd_inputs(gen, g, t, h, n, p, t, dev)
            err, _ = ssd_case(f"launched in {phases}", args)
            max_err["ssd_chunk_tc"] = max(max_err["ssd_chunk_tc"], err)
        elif key[0] in GOSSIP:
            max_err[key[0]] = max(max_err[key[0]],
                                  gossip_case(gen, key, dev))
        else:
            _, dtype, t, e, k = key
            err, bad = router_case(gen, t, e, k, getattr(torch, dtype),
                                   dev)
            if bad > 2:
                fail(f"moe_router at {key}: {bad} rows with swapped "
                     f"indices")
            max_err["moe_router"] = max(max_err["moe_router"], err)
    if seen - CHECKED:
        fail(f"shapes left unchecked: {sorted(seen - CHECKED, key=str)}")


# ---------------------------------------------------------------------------
# [12] the benchmark harness (benchmarks/port_kernel_bench.py)
# ---------------------------------------------------------------------------

# the contract benches' epochs in [12]: (superstep epochs, eval_every),
# quant convergence, FedAvg dispatch, scenario overhead, the trust and
# telemetry chunks (the bench's defaults: 200/50, 200, 120, 60, 20)
HARNESS_EPOCHS = dict(superstep=(20, 5), quant=20, fedavg=12, scenario=12,
                      trust=8)


def bench_harness(dev, max_err: dict):
    """Phase [12] (see the module docstring). Returns the launches."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import port_kernel_bench as kb
    from repro_torch.kernels import ops
    e = HARNESS_EPOCHS
    seen = set()
    ops.reset_launches()
    with launched_kernel_shapes(seen):
        rows = kb.gossip_rows(4096, dev)
        krows = kb.run(dev)
        c = dict(
            superstep=kb.bench_superstep(*e["superstep"], device=dev),
            quant_convergence=kb.bench_quant_convergence(e["quant"],
                                                         device=dev),
            fedavg_dispatch=kb.bench_fedavg_dispatch(e["fedavg"],
                                                     device=dev),
            scenario_overhead=kb.bench_scenario_overhead(e["scenario"],
                                                         device=dev),
            geom_trust=kb.bench_geom_trust(e["trust"], device=dev),
            corr_trust=kb.bench_corr_trust(e["trust"], device=dev),
            telemetry=kb.bench_telemetry(e["trust"], device=dev))
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    want_calls = {"dense": {"gossip_mix": 1},
                  "sparse": {"gossip_mix_sparse": 1},
                  "quant": {"gossip_mix_quant": 1}}
    for r in rows:
        label = f"12 gossip W={r['W']} density={r['density']}"
        print(f"  {label} K={r['K']} F=4096: dense {r['dense_us']:.2f}us "
              f"({r['dense_regime']}), sparse {r['sparse_us']:.2f}us, "
              f"int8 {r['quant_us']:.2f}us, torch.matmul "
              f"{r['einsum_us']:.2f}us, torch.sparse.mm "
              f"{r['sparse_library_us']:.2f}us; bounds {r['bound_us']}; "
              f"err sparse {r['max_err']:.2e} dense {r['dense_err']:.2e} "
              f"int8 kernel {r['quant_kernel_err']:.2e} (step "
              f"{r['quant_step']:.2e}) wire {r['quant_wire_err']:.2e}; "
              f"int8 bytes {r['int8_fp32_byte_ratio']:.4f}x fp32")
        if r["launches"] != want_calls:
            fail(f"{label}: launches {r['launches']}")
        if not (r["max_err"] <= 1e-4 and r["dense_err"] <= 1e-4
                and r["quant_kernel_err"] <= r["quant_step"]
                and r["int8_fp32_byte_ratio"] <= 0.3):
            fail(f"{label}: a mix disagrees with its plain version or the "
                 f"int8 wire's bytes exceed 0.3x fp32")
        for name, err in (("gossip_mix", r["dense_err"]),
                          ("gossip_mix_sparse", r["max_err"]),
                          ("gossip_mix_quant", r["quant_kernel_err"])):
            max_err[name] = max(max_err[name], err)
    for r in krows:
        lib = "-" if r["library_us"] is None else f"{r['library_us']:.2f}us"
        print(f"  12 kernel {r['name']}: {r['us_per_call']:.2f}us, plain "
              f"{r['ref_us']:.2f}us, library {lib}, bound "
              f"{r['bound_us']:.3f}us ({r['bound_by']}), launches "
              f"{r['launches']}, max_err {r['max_err']:.2e}")
        if sum(r["launches"].values()) != 1:
            fail(f"12 kernel {r['name']}: launches {r['launches']}")
    ratios = {"scenario": c["scenario_overhead"]["ratio"],
              "geom": c["geom_trust"]["ratio"],
              "corr": c["corr_trust"]["ratio_corr"],
              "all": c["corr_trust"]["ratio_all"],
              "telemetry": c["telemetry"]["ratio"]}
    print(f"  12 wall ratios (not gated): {ratios}")
    parity = {"scenario_overhead": ("static", "scenario"),
              "geom_trust": ("loss", "geom"),
              "corr_trust": ("loss", "corr", "all"),
              "telemetry": ("off", "on")}
    for entry, variants in parity.items():
        got = [(c[entry][f"dispatches_{v}"],
                c[entry][f"launches_per_round_{v}"]) for v in variants]
        print(f"  12 {entry}: (chunks, launches a round) "
              f"{dict(zip(variants, got))}")
        if any(g != got[0] for g in got) or not sum(got[0][1].values()):
            fail(f"12 {entry}: chunks or launches a round differ across "
                 f"{variants}: {got}")
    fd = c["fedavg_dispatch"]
    if fd["dispatches_fedavg"] != fd["dispatches_defta"]:
        fail(f"12 fedavg_dispatch: chunks {fd}")
    if not c["quant_convergence"]["rel_delta"] < 0.02:
        fail(f"12 quant convergence {c['quant_convergence']}")
    print(f"  12 launches {launches}; {len(seen)} shapes launched",
          flush=True)
    print("[12c] the kernel shapes of [12] against the plain versions",
          flush=True)
    check_launched_shapes(dev, seen, max_err, phases="[12]")
    return launches


def spills(log: str) -> dict:
    """{entry function: spilled bytes (stores + loads)} from ptxas -v."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            out[entry] = int(m.group(1)) + int(m.group(2))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device(None)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    report = build.build()
    print(f"[1] build: {time.perf_counter() - t0:.1f}s wall "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if any(w in line.lower() for w in ("registers", "spill",
                                                "warning")):
                print(f"  ptxas {name}: {line.strip()}")
        for entry, spilled in spills(r["log"]).items():
            if spilled and (name in ("ssd_chunk_tc", "flash_attention",
                                     "moe_router", "moe_route_slots") or (
                    name == "gossip_mix" and "tile_mix_kernel" in entry)):
                fail(f"{name} spills registers in {entry}")

    print("[2] kernels vs plain versions", flush=True)
    max_err = check_kernels(dev)
    check_identity_rows(dev)
    check_sparse_nonfinite(dev)
    max_err.update(check_flash(dev))
    max_err["moe_router"] = check_router(dev)
    max_err["moe_route_slots"] = check_route_slots(dev)
    check_grouped_capture(dev)
    max_err.update(check_ssd(dev))

    print("[3] timings", flush=True)
    main_t = time_kernels(dev, "main", 22, 4, 2048)
    time_kernels(dev, "T3", 60, 4, 2048)    # the dense mix's tile regime
    time_kernels(dev, "k64", 64, 4, 2048)   # the cross-device cohort's
    time_kernels(dev, "w500", 500, 24, 4096)
    main_t.update(time_serving_kernels(dev))
    time_encdec_flash(dev)
    time_simt_flash(dev)
    main_t.update(time_route_slots(dev))
    main_t.update(time_ssd(dev))

    print("[4] DeFTA, FedAvg and AsyncDeFTA end to end", flush=True)
    card_vs_cpu()
    launches = end_to_end()
    fedavg_end_to_end()
    async_end_to_end(launches)

    print("[4s] scenarios end to end", flush=True)
    scenario_end_to_end(launches)

    print("[4t] DTS v2 and v3 trust channels end to end", flush=True)
    trust_end_to_end(launches)

    print("[4c] cross-device participation end to end", flush=True)
    cross_device_end_to_end(launches)

    print("[4p] the privacy wire end to end", flush=True)
    privacy_end_to_end(launches)

    print("[4m] telemetry and the launcher", flush=True)
    telemetry_end_to_end(launches)

    print("[4w] worker-axis sharding end to end", flush=True)
    for k, v in check_shard_blocks(dev).items():
        max_err[k] = max(max_err[k], v)
    shard_end_to_end(launches)

    print("[4f] LM training and DeFTA across pods (--fl)", flush=True)
    t4f = time.perf_counter()
    for k, v in check_flash_grad(dev).items():
        max_err[k] = max(max_err[k], v)
    fl_tc, pod_params = fl_end_to_end(dev)
    fl_pod_mixes(dev, pod_params, launches, max_err)
    del pod_params
    fl_simt = fl_example(dev)
    torch.cuda.empty_cache()
    print(f"  [4f] {time.perf_counter() - t4f:.1f}s", flush=True)

    print("[5] serving end to end", flush=True)
    launches.update(serve_full(dev))
    # f32 attention keeps the SIMT flash kernel: its path is the reduced
    # f32 model served on the card (and [4f]'s f32 example)
    launches["flash_attention"] = serve_reduced_card_vs_cpu(
        dev, "deepseek-moe-16b", 24, attention=True)["flash_attention"]
    launches["flash_attention_tc"] += fl_tc
    launches["flash_attention"] += fl_simt

    print("[6] serving mamba2-780m end to end", flush=True)
    launches.update(serve_mamba2(dev))
    reduced = serve_reduced_card_vs_cpu(dev, "mamba2-780m", 40,
                                        attention=False)
    if not reduced["ssd_chunk_tc"]:
        fail(f"reduced mamba2 (N = 16, P = 32): SSD launches {reduced}, "
             f"expected ssd_chunk_tc")

    print("[7] jamba, one period at full width", flush=True)
    prefill_jamba_period(dev)

    print("[8] whisper-tiny and InternVL2-2B end to end", flush=True)
    t8 = time.perf_counter()
    launches["flash_attention_tc"] += serve_encdec(dev)
    # f32 whisper runs the SIMT kernel: at full width (D = 64) and reduced
    # (D = 42, the kernel's masked columns), card vs CPU
    from repro_torch.configs import get_config
    whisper_f32 = dataclasses.replace(get_config("whisper-tiny"),
                                      dtype="float32")
    for cfg, seq in ((whisper_f32, 24), (None, 24)):
        launches["flash_attention"] += serve_reduced_card_vs_cpu(
            dev, "whisper-tiny", seq, attention=True,
            cfg=cfg)["flash_attention"]
    print(f"  [8] {time.perf_counter() - t8:.1f}s", flush=True)

    print("[9] training the moe, ssm and hybrid families; expert "
          "parallelism", flush=True)
    t9 = time.perf_counter()
    counts, _ = train_and_expert_parallel(dev)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  [9] {time.perf_counter() - t9:.1f}s", flush=True)

    seen = set()
    print("[10] launch costing: the dry run's counts against the card's",
          flush=True)
    t10 = time.perf_counter()
    with launched_shapes(seen):
        tp_launches = launch_costing(dev)
    for k, v in tp_launches.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  [10] {time.perf_counter() - t10:.1f}s", flush=True)

    print("[11] tensor parallelism inside a pod", flush=True)
    t11 = time.perf_counter()
    with launched_shapes(seen):
        tp_launches = tensor_parallel(dev)
    for k, v in tp_launches.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  [11] {time.perf_counter() - t11:.1f}s", flush=True)
    print("[11c] the kernel shapes of [10] and [11] against the plain "
          "versions", flush=True)
    check_launched_shapes(dev, seen, max_err)

    print("[12] the benchmark harness (benchmarks/port_kernel_bench.py)",
          flush=True)
    t12 = time.perf_counter()
    for k, v in bench_harness(dev, max_err).items():
        launches[k] = launches.get(k, 0) + v
    print(f"  [12] {time.perf_counter() - t12:.1f}s", flush=True)

    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=max_err[k], **main_t[k]) for k in REPLACES]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
