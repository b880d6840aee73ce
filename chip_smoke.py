#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which exits non-zero on failure:

1. build the msj_scan CUDA kernels from ``src/repro_torch/kernels/msj_scan/
   csrc`` with nvcc for sm_90a (into ``build/``) and print ptxas' report;
2. run each kernel on the card at the full width of the Figure-1 workload
   (k in {256, 2048}: its C, slots, h, and the ring capacity q_cap = 8192
   of a 100 000-job trace) with R = 16 replications and J = 2000 jobs,
   and require ``torch.equal`` with its plain PyTorch version on the same
   inputs (J is shortened because the plain version is a Python event
   loop); time the kernel and the plain version on the card;
3. drive the main path, ``sweep_many_server(figure1_workload, (256, 1024,
   2048), num_jobs=100_000, reps=16)`` for FCFS, ModBS-π and BS-π on the
   card, with every kernel's launch count set to 0 just before and read
   just after; check the results (finite; BS-π's P[wait > 0] falls as k
   grows and its mean response at k = 2048 is below FCFS's — the paper's
   trend) and a small sweep on the card against the same sweep on the
   CPU, field by field;
4. time each kernel at the main path's largest shape.

The Figure-3 slice adds to each phase:

1. ``csrc/srpt_scan.cu`` builds beside ``msj_scan.cu`` (one nvcc each, in
   parallel) and ptxas' report covers its kernels;
2. ``srpt_scan`` (SF and FF) at the full width of the Fig. 3 path's
   largest cells, k in {512, 1024} with Q = 2048 / 4096 slots, on R = 4
   IID-bootstrapped SDSC-SP2 replications at load 0.85 with J cut to 1000
   (2000 until the cross-attention slice; the plain version is a Python
   event loop); KIT-FH2 (78 % need-1 jobs)
   at k = 1024, J = 1000; a burst (k = 512, Q = 2048, J = 500 in 5
   batches of 100 equal arrival times, services from 4 values: ties on
   arrival and rank, and hundreds of jobs in the system, the kernel's
   large-n path); an overflowing table (Q = 4, J = 300); and
   ``stable_sort`` at W in {4096, 3000}; each ``torch.equal`` to its plain
   version on the card and on the CPU, with the jobs in the system per
   event printed;
3. ``repro_torch.bench.fig3_traces.run(policies=SCAN_POLICIES)`` on the
   card (2 datasets x k in {512, 1024} x 3 loads x the 5 scan policies,
   J = 15 000, R = 4) with the counts set to 0 just before and read just
   after:
   every row must be finite (the launch counts: see the grid slice); a
   small run on the card must equal the same run on the CPU on every
   column but ``sim_s``.  Rows are printed; no ordering between policies
   is asserted (on the reference BS-π is above FCFS at this J);
4. ``srpt_scan`` timed at k = 1024, Q = 4096, R = 4, J = 15 000 on
   SDSC-SP2 and KIT-FH2 and on the J = 1500 burst (time per event and the
   jobs in the system per event), and ``stable_sort`` at [4, 4096] beside
   two stable ``torch.sort`` passes.  (``python -m
   repro_torch.bench.srpt_bench --parent DIR`` times another checkout's
   kernel beside this one.)

The drain-mode failure slice adds:

2. ``fcfs_fail_scan``, ``modbs_fail_scan`` and ``bs_fail_scan`` at the
   Figure-1 widths of k in {256, 2048}, R = 16, J = 400 (ring capacity
   q_cap = J, so no ring can overflow), under two outage mixes over the
   arrival horizon h: ``bench_sim.bench_failures``' process (mtbf = h/4,
   mttr = h/400, single servers) and a heavier one (mtbf = h/4,
   mttr = h/40, pods of 4 servers, which exercises class drains on free
   slots and the slot dedup of pod outages); each ``torch.equal`` to its
   plain version on the card on every raw output, failure rows included;
3. the drain path, ``sweep_many_server(figure1_workload, (256, 1024),
   num_jobs=100_000, reps=16, failures=<bench_failures' process>)`` for
   FCFS, ModBS-π and BS-π on the card, counts set to 0 just before: every
   fail kernel must launch, every metric be finite and availability lie
   in (0, 1]; the rows are printed beside the clean sweep's, with no
   ordering asserted (k = 2048 is left out: with the default ring of
   8192 BS-π overflows there, on the reference too); then a small drain
   run (J = 2000, R = 4, k in {256, 2048}) on the card must equal the CPU
   run on every ``BatchSimResult`` field;
4. each fail kernel timed at k = 2048, R = 16, J = 100 000 (BS-π with
   q_cap = J).

The LLM serving slice adds (``serving_path``):

1. the attention library (``flash_attention/csrc/flash_attention.cu`` and
   ``decode_attention/csrc/decode_attention.cu``), built in the same
   parallel step as msj_scan's, with ptxas' report;
2. ``flash_attention`` at B = 1, S = 2048, causal, at yi-9b's heads
   (H 32, Kh 4, D 128), stablelm-3b's (H 32, Kh 32, D 80) and, for the
   MoE and hybrid slices, moonshot-v1-16b-a3b's (H 16, Kh 16, D 128) and
   jamba-1.5-large's (H 64, Kh 8, D 128) in bfloat16 and
   in float32, and ``decode_attention`` at B in {1, 4}, Sk = 8192, random
   pos, at the four head shapes in bfloat16 and (B = 4) in float32,
   each within 1e-5 + 2^-6 |ref| (bfloat16: two units in the last place)
   or 2e-5 + 2e-5 |ref| (float32) of its plain version on the card;
3. a ``ServingEngine`` on the card with test_substrate's request classes
   at full width (stablelm-3b on 2 chips, yi-9b on 8, fleet 64, bucket
   8192): 20 arrivals, then one admitted request of each class at each
   prompt length (512, 2048) runs end to end (32 tokens), with the launch
   counts set to 0 just before and read just after: flash_attention must
   launch L times per prefill and decode_attention L times per token
   after the first; tokens lie in the vocabulary, logits are finite,
   prefill(511) + decode equals prefill(512) layer by layer within
   ``bench/decode_vs_forward.LAYER_TOL`` of each row's largest element
   (each decode layer fed the prefill's input; the free-running last
   logits are printed), and a reduced float32 engine with the same
   weights gives the same tokens on the card as on the CPU;
4. each attention kernel's time beside its plain version's, the
   ``scaled_dot_product_attention`` yardstick's and its bound.

The MoE serving slice adds (``moe_path``, after the dense phase's weights
are freed):

1. the grouped-matmul library (``moe_gmm/csrc/moe_gmm.cu``), built in the
   same parallel step;
2. ``gmm`` at moonshot-v1-16b-a3b's shapes, E = 64 experts: prefill
   (C = 240, block_m 128, M = 16 384, and at 512 tokens C = 60, block_m
   64, M = 4096) gate/up (K 2048, N 1408) and down (K 1408, N 2048) with
   a skewed fill that leaves some experts empty, and decode (C = 6, block_m 16, 6 experts with one row, 58 with
   nvalid == 0), junk in every padding row and empty block, in bfloat16
   and float32, within the attention limits of its plain version on the
   card (float32 sums of up to 2048 terms in another order are far inside
   them at these scales) and with skipped blocks exactly zero; each timed
   beside its plain version, a ``torch.bmm`` over the [E, Cp, K] buffer
   and its bound;
3. a ``ServingEngine`` on the card with stablelm-3b (2 chips, α 0.8) and
   moonshot-v1-16b-a3b (8 chips, α 0.2) at full width and depth (56.1 GB
   of bf16 weights): 20 arrivals, then one admitted moonshot request at
   each prompt length (512, 2048) runs 32 greedy tokens with the launch
   counts set to 0 just before and read just after: gmm 3 x 48 per
   prefill and per token after the first, flash_attention 48 per prefill,
   decode_attention 48 per token after the first; tokens lie in the
   vocabulary; prefill and decode times and the dropped (token, slot)
   pairs per prefill (each prefill's MoE inputs routed again after it)
   are printed; decode-vs-forward is held to 0.25
   where neither pass dropped a pair (capacity C = 60 at 512 tokens can
   drop; decode's C = 6 never does), else printed with the drop counts;
   a reduced float32 engine with the same weights gives the same tokens
   on the card as on the CPU; the phase's peak memory is printed.

The RWKV6 serving slice adds (``rwkv_path``, after the MoE phase's
weights are freed):

1. the WKV library (``rwkv6/csrc/wkv.cu``), built in the same parallel
   step;
2. ``wkv`` at rwkv6-7b's prefill shapes (B 1, S 2048, H 64, N 64, chunk
   64) with bfloat16 and with float32 r / k / v (float32 logw, u and
   state), zero and carried state, log decays from the model's init range
   and from [-1, -0.01], and a ragged S = 2047: y within 5e-4 + 1e-3
   |ref| of its plain version on the card, plus two units in the last
   place in bfloat16, and s_T within 5e-4 + 1e-3 |ref|; timed beside its
   plain version and its bound (no PyTorch call computes it) and the share
   of the bound it reached; the same limits at the edge shapes of its
   chunk-parallel split (``WKV_EDGE``: S = 1, S below the chunk, N 48 and
   5, chunks of 16 and 8, B = 2; both dtypes, zero and carried state);
3. a ``ServingEngine`` on the card with stablelm-3b (2 chips, α 0.8) and
   rwkv6-7b at its ``chips_needed`` (2 chips, α 0.2) at full width and
   depth (15.1 GB of bf16 weights, seed 0): 20 arrivals, then one admitted
   rwkv request at each prompt length (512, 2048) runs 32 greedy tokens
   with the launch counts set to 0 just before and read just after: wkv
   exactly L per prefill and none per decoded token, the attention and
   gmm kernels none; tokens lie in the vocabulary, logits are finite,
   prefill(511) + decode equals prefill(512) within 0.25 (the 511-token
   prefill ends in a ragged chunk), and a reduced float32 engine gives
   the same tokens on the card as on the CPU; prefill and decode times
   and the phase's peak memory are printed.

The hybrid serving slice adds (``hybrid_path``, after the RWKV phase's
weights are freed):

1. the selective-scan library (``mamba_scan/csrc/mamba_scan.cu``), built
   in the same parallel step; the attention checks of the dense phase
   also run at jamba's heads (H 64, Kh 8, D 128);
2. ``mamba_scan`` at jamba-1.5-large's layer (B 1, S 2048, d_inner
   16384, N 16): the fused entry the model calls (dt, A, Bm, C float32,
   u bfloat16 or float32) with zero and carried h0, decays from the
   model's init (``mamba_dt``, ``mamba_A``) and with a in [0.5, 0.99], and
   a ragged S = 2047, y and h_T within 1e-4 + 1e-4 |ref| of its plain
   version on the card; the reference kernel's entry on pre-discretised
   a / b in float32 and bfloat16 (y bfloat16: plus two units in the last
   place); each entry timed beside its plain version and its bound (no
   PyTorch call computes the scan) and the share of the bound it reached;
   the fused entry also at the edge shapes of its tiling (``MAMBA_EDGE``:
   S = 1, N 7 / 12 / 13 / 5, d_in 200 / 97 / 300, B = 2; both u dtypes, zero
   and carried h0); ``gmm`` at the cut's expert shapes (8
   held experts of 8192 x 24576: a 2048-token prefill's and one token's
   gate/up and down) against its plain version one expert at a time,
   timed beside ``torch.bmm`` and its bound;
3. a ``ServingEngine`` on the card with stablelm-3b (2 chips, α 0.8) and
   the cut of jamba-1.5-large that ``hybrid_cut`` states (one block of 8
   layers at full width, 8 of 16 experts held; 25.9 B params, 52.3 GB on
   the card): 20 arrivals, then one admitted jamba request at each prompt
   length (512, 2048) runs 32 greedy bf16 tokens with the launch counts
   set to 0 just before and read just after: ``mamba_scan`` exactly 7 per
   prefill and none per token, ``flash_attention`` 1 per prefill,
   ``decode_attention`` 1 per token after the first, ``gmm`` 3 x 4 per
   prefill and per token after the first, ``wkv`` none; tokens lie in the
   vocabulary, logits are finite; the dropped (token, slot) pairs and
   those routed to the experts held elsewhere are printed per prefill;
   decode-vs-forward after prefill(511) is held to 0.25 where neither
   pass dropped a pair, else printed with the drop counts; a reduced
   float32 engine (4 of 8 experts held) gives the same tokens on the card
   as on the CPU; prefill and decode times and the phase's peak memory
   are printed.

The tensor-core slice (bf16 ``flash_attention`` and prefill ``gmm`` on
wgmma fed by TMA) adds:

1. ``flash_attention/csrc/flash_attention_tc.cu`` and
   ``moe_gmm/csrc/moe_gmm_tc.cu`` (with ``kernels/csrc/hopper.cuh``),
   built in the same parallel step into the attention and gmm libraries;
   after the build every kernel's tensor-core instructions (HGMMA, HMMA)
   in ``cuobjdump --dump-sass`` are printed, and a tensor-core kernel with
   none fails the run ("not available" where the toolkit has no
   ``cuobjdump``);
2. each ``flash_attention`` and ``gmm`` ``[kernel]`` case prints the route
   its wrapper took: every bf16 flash case and every bf16 gmm case with
   block_m a multiple of 64 (the prefills) must take ``wgmma``, every
   float32 case ``simt``; limits and launch counts as before;
3. the ``[serve]`` phase keeps each layer's flash call of the 512-token
   prefill (``bench/decode_vs_forward.keep_flash_calls``) and holds its
   output to the plain version at the bf16 limit, with the ``simt``
   kernel's reading on the same inputs printed beside it: the served
   models' own scores, large and near-tied at the reference's init;
4. each ``[time]`` line of a ``wgmma`` case also prints the ``simt``
   kernel it replaced on the same inputs in the same run.

The decode-kernel slice (``decode_attention`` and the ``"mma"`` route of
``gmm`` redesigned for the card's memory system) adds:

1. ``moe_gmm/csrc/moe_gmm_dec.cu`` built into the gmm library; its
   ``gmm_dec_kernel`` must hold HMMA (mma.sync) instructions in
   ``[sass]``, as the wgmma kernels must hold HGMMA;
2. every bf16 ``gmm`` case with block_m 16 or 32 (moonshot's decode, the
   jamba cut's decode gate/up and down) must take ``mma``; float32 cases
   ``simt``; ``decode_attention`` keeps its cases and limits;
3. ``[time]`` lines of both kernels print the share of the bound the
   kernel reached, and each decode ``gmm`` line the ``simt`` kernel's
   time on the same call; every ``[time]`` reading is device time (the
   calls queued behind a sleep kernel, so the host's time per call is
   not read as the kernel's).

The BS-π redesign slice (``bs_scan`` / ``bs_fail_scan`` with no global
read on a step's chain; ``srpt_scan`` past 4096 slots) adds:

2. ``bs_scan`` and ``bs_fail_scan`` on every case of
   ``repro_torch.bench.bs_cases.ADVERSARIAL`` (J = 2000, R = 4: rings of
   six entries that wrap and overflow in some replications, KIT-FH2 at
   k = 512 with four of seven classes wholly on the helper, tied arrival,
   completion and commit times, SDSC-SP2's seven classes, the heavier
   drain mix), each ``torch.equal`` to its plain version on the CPU on
   every raw output, with the kernel's time per step; ``srpt_scan`` SF
   and FF at Q = 8192 (the slot table in global scratch): SDSC-SP2 at
   k = 2048, R = 4, J = 500, and one batch of 4200 equal arrivals at
   k = 4200, R = 1 (more than 4096 jobs in the system), each
   ``torch.equal`` to the plain version on CPU and card, with its time
   per event (the wide burst against the CPU run only: its plain version
   takes ~1 min a policy);
4. the ``[time]`` lines of the clean scans give the time per step.
   (``python -m repro_torch.bench.bs_bench --parent DIR --phases`` times
   another checkout's BS kernel beside this one and splits a step.)

The FCFS / ModBS-π redesign slice (``fcfs_scan``, ``modbs_scan`` and
their drain variants on one warp per replication, the run-length
free-time state and kept class-row minima) adds:

2. the four kernels on every case of
   ``repro_torch.bench.fm_cases.ADVERSARIAL`` (J = 2000, R = 4: ties on
   the 1/4 grid, zero services, jobs needing all k servers, k in {1, 7,
   33, 1000}, need-1 jobs whose distinct completions make one group a
   server, class rows wider than 32, classes with no slots, a helper of
   one server, drain rows whose t_up lies below W[0], between and above
   the last start, padding rows, KIT-FH2 at k = 512 and the heavier drain
   mix), each ``torch.equal`` to its plain version on the CPU on every
   raw output, with the kernel's time per step;
4. ``fcfs_scan`` and ``modbs_scan`` timed at every Fig. 1 k (256, 1024
   and 2048), µs per step.  (``python -m repro_torch.bench.fm_bench
   --parent DIR --phases`` times another checkout's kernels beside these
   and splits a step.)

The grid slice (``engines.simulate_grid`` stacks a grid's cells x
replications onto one launch of each scan kernel) adds to phase 3: each
path's launches, counted from 0 just before it, must be exactly one of
each kernel per policy — the Fig. 1 sweep one ``fcfs_scan``,
``modbs_scan`` and ``bs_scan``; the Fig. 3 path one each of those and two
of ``srpt_scan`` (SF and FF); the drain sweep one of each fail kernel —
and each path is run again cell by cell (``grid=False``), which must give
the same result on every field (Fig. 3: every column) but ``sim_s``; both
walls are printed.

The stream slice (``engines.simulate_stream`` over a chunk source, one
carried launch of ``fcfs_stream_scan``, ``modbs_stream_scan`` or
``bs_stream_scan`` per chunk) adds a phase 3d: each carried kernel
against its plain version on the card after every chunk (outputs and
canonical carry ``torch.equal``; Fig. 1 at k = 2048, J = 1000, R = 16 in
chunks of 250, BS-π at the stream core's default backlog_cap, and the adversarial cases ``bursts`` — more than 128
run-length groups carried —, ``need1``, ``ties`` and BS-π's ``kit512``);
Fig. 1's batch at k in {2048, 256}, R = 16, J = 100 000 streamed in
chunks of 10 000 and 7 919 (ragged) for the three policies, each equal
bit for bit to ``stream_fold(simulate(...))`` on the card with one launch
per chunk; a generated BS-π stream (``PoissonSource``, Fig. 1 k = 2048,
R = 16) of 2 x 10^5 and of 10^6 jobs a replication whose peak device
memory must not grow by more than 5 %, the longer one checkpointed every
chunk, its last step deleted and resumed to the same bytes; and each
carried kernel's device time per chunk beside its bound.  The RWKV6
serving phase adds the teacher-forced, layer-by-layer decode-vs-forward
check (each layer within ``bench/decode_vs_forward.LAYER_TOL`` of its
row's largest element) beside the free-running one.  The comparisons of
phase 2 run at J = 2000 (4000 before) and the drain ones at J = 1000
(2000 before), to pay for the stream phase's time.

The event-engine slice (``engine="python"``, the port's copy of the
reference's event-driven simulator and its eleven policies) adds a phase
3e, the paper's policy set: each scan kernel of FCFS, ModBS-π, BS-π,
SF-SRPT and FF-SRPT on the card equal on every ``BatchSimResult`` field
to ``engine="python"``, host code that shares nothing with the kernels or
their plain versions (a Fig. 1 batch at k = 256, J = 2000, R = 2; an
SDSC-SP2 bootstrap at k = 512, load 0.85, J = 1000, R = 2; the three
drain policies at k = 256, J = 1000, R = 2 under bench outages);
``fig3_traces.run`` on ``engine="python"`` equal to the run on the card
on every column but ``sim_s`` and ``engine`` (J = 800, k = 256, load
0.7, R = 2); and ``fig3_traces.run(ks=(1024,), loads=(0.85,), reps=2)``,
the paper's six policies at J = 15 000 on both datasets, with the counts
set to 0 just before and read just after: one launch each of
``fcfs_scan`` and ``bs_scan`` and two of ``srpt_scan``, ``serverfilling``
and ``msf`` on the event engine with one fallback warning each, every row
finite or the reference's infinite row with a note; the kernel rows' and
the event-engine rows' ``sim_s`` are summed apart.  The drain comparisons
of phase 2 run at J = 800 (1000 before) to pay for the phase.

The theory slice (Erlang-B, ``core/theory.py``, the M/GI/s/s loss queue
on the ``loss_scan`` kernel, the Fig. 1 / Fig. 2 / Thm 1-2 drivers and
the real-log SWF path) adds a phase 3f, ``[theory]``: ``loss_scan``
``torch.equal`` to its plain version on the card and on the CPU (R = 4,
J = 2000, s in {1, 6, 24, 196, ``LOSS_S_MAX``} at an offered load of
1.1 s, and equal arrival times) and to the heapq oracle of
``bench/loss_cases`` at full width (R = 16, J = 100 000, s = 10, λ = 8,
d = 1; blocking within 0.01 of Erlang-B); then, with the counts set to 0
just before and read just after, Property 1 at Fig. 1 k = 2048, J =
100 000, R = 16 (``modbs_scan``'s blocked mask of each class equal to
``loss_scan`` with slots[c] on that class's substream; P_H within 0.01
of eq. (16)), ``bench/fig2_regimes``' two sweeps at the defaults' cells
(J = 100 000, R = 8), ``bench/theory_tables.run`` at its default
``mc_jobs`` of 150 000 and ``fig3_traces.run_swf`` on an SDSC-SP2 log
that ``write_swf`` wrote (J = 15 000, R = 4, the five scan policies):
four launches of ``loss_scan``, nine of ``modbs_scan``, three each of
``fcfs_scan`` and ``bs_scan``, two of ``srpt_scan``; phase 3's Fig. 1
rows with ``bench/fig1_critical``'s ``ph_bound`` and ``zero_wait_R``
columns (ModBS-π's P_H within 0.01 of ``ph_bound`` at each k); each
driver card == CPU at a small size; and ``[time] loss_scan`` at R = 16,
J = 100 000, s = 10 and 196 beside its bytes bound.  The drain
comparisons of phase 2 run at J = 600 (800 before) to pay for the phase.

The cross-attention and MLA slice (the vlm, encdec and MLA families in
``models/``) adds two serving phases after ``[serve-hybrid]``, each on
the card's memory alone (the phase before it freed):

3. ``[serve-xattn]`` (``xattn_path``): seamless-m4t-large-v2 at full size
   (2.03 B params, 4.1 GB) and llama-3.2-vision-90b cut by ``vlm_cut``
   (one block of 4 self-attention layers and 1 cross-attention layer at
   full width, 6.4 B params, 12.8 GB; its zero-init gate set to
   ``VLM_GATE``), two requests each (prompts 512 and 2048, 32 greedy
   tokens) through ``init_cache`` / ``prefill`` / ``decode_step`` (the
   engine prefills tokens only, on the reference too: ROADMAP R7), with
   stub frames of 1024 / 2560 rows (the cache's length, rounded up to
   whole 512-row attention chunks, so that no zero row enters decode:
   R6) or 1024 image tokens, made with numpy from a seed; the launch
   counts set to 0 just before and read just after: flash 72 a seamless
   prefill (encoder 24, decoder self 24 and cross 24) and 5 a vlm one,
   decode 48 and 5 a token after the first; every flash call of the
   served prefills (encoder non-causal Sq = Sk, cross Sq < Sk, wgmma) and
   every decode call of a step (self, and cross at S_src - 1) held to its
   plain version on the model's own inputs (decode with the atol at the
   data's scale, ``keep_decode_calls``) and the decode shapes on random
   inputs at the bf16 limit; decode-vs-forward layer by layer within
   ``LAYER_TOL``; each shape timed beside SDPA and its bound; card == CPU
   on the reduced float32 configs;
4. ``[serve-mla]`` (``mla_path``): ``gmm`` at deepseek-v3's 256 experts
   (C = 80 at 2048 tokens: wgmma; C = 20 at 512 and 8 at decode: mma)
   against its plain version one valid expert at a time and timed; a
   ``ServingEngine`` on ``mla_cut`` (3 dense + 2 MoE layers at full
   width, 26.6 B params, 53.2 GB), two requests (512, 2048) with the
   counts set to 0 just before: flash 5 a prefill (MLA at D = 192, Dv =
   128: the CUDA-core kernel), gmm 3 x 2 a prefill and a token,
   decode_attention none (MLA decodes in the reference's absorbed form,
   plain products); the dropped pairs; MLA's flash calls held to the
   plain version and timed; decode-vs-forward layer by layer held to
   ``MLA_LAYER_TOL`` on the layers where the prefill's last token dropped
   no pair; card == CPU on a reduced float32 engine.

The SDSC-SP2 comparisons of ``srpt_scan`` at k in {512, 1024} run at
J = 1000 (2000 before) to pay for the two phases.

The serving-driver slice (``launch/serve.py``, ``sched/elastic.py``,
``runtime/``) adds the G = 9 and G = 6 heads (starcoder2-7b, H 36 / Kh 4;
internlm2-20b, H 48 / Kh 8) to ``[serve]``'s kernel cases and times, and
a phase after ``[serve-mla]``, on the card's memory alone:

5. ``[serve-driver]`` (``driver_path``): ``run_epochs`` at the driver's
   defaults (fleet 512, 4 epochs of 6000 jobs in chunks of 2000, R 2,
   load 0.8, period 3600 s, amplitude 0.5: three rescales) for fcfs,
   modbs-fcfs and bs-fcfs with the stream counts set to 0 just before
   and read just after (one carried launch a chunk, 12 a run), each run
   card == CPU on every printed line and ``StreamResult`` field (the CPU
   runs, one process a policy, go on while the card serves);
   ``main(["--execute", "5"])`` with every
   count set to 0 just before and read just after (the epoch loop's 12
   ``bs_stream`` launches; starcoder2-7b and yi-9b at full size and
   deepseek-v3 cut by ``serve.cuts.mla_cut(cfg, moe_layers=1)``, 68 GB
   of bf16 weights held together: flash L a prefill, decode L a token
   after the first, ``gmm`` 3 a token), each request's prefill and decode
   wall, the weights' draw and the peak memory; the first request of
   each class again warm and then with every flash, decode and ``gmm``
   call held to its plain version (same tokens); starcoder2-7b's
   decode-vs-forward layer by layer within ``LAYER_TOL``; a
   ``llamav-32k`` request raising ``KeyError`` with the card's memory
   unchanged.  To pay for the phase, the drain comparisons of phase 2
   run at J = 400 (600 before).

The training slice (``models/`` train mode, ``optim/``, ``train/``,
``data/pipeline.py``, ``run_with_restarts``, ``launch/train.py``) builds
``flash_attention/csrc/flash_attention_bwd.cu`` with the attention
library and adds a last phase:

6. ``[train]`` (``train_path``): the flash backward kernel against its
   plain version at stablelm-3b's call (B 4, S 2048, H 32, D 80), yi-9b's
   (G 8), starcoder2-7b's (G 9), MLA's D 192 / Dv 128 and one float32
   case, timed beside its bound and SDPA's backward, both forward routes'
   lse checked; stablelm-3b at full size (2.796 B params) through the
   ``Trainer``, four steps at microbatches 1 and four at 2, the flash
   counts set to 0 just before and read just after (forward 64, backward
   32 a microbatch), loss, grad_norm, lr and wall a step, tokens/s and
   the peak memory, layers 31 and 0's first backward calls held to the
   plain version; reduced stablelm-3b / yi-9b three steps card == CPU;
   the restart drill bit for bit; reduced MoE, RWKV6 and jamba train
   steps refused naming ``gmm`` / ``wkv`` / ``mamba_scan``; the launcher
   on the card.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository around it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (J of the comparisons with the plain versions: 4000 until the stream
# slice, halved to pay for its phase)
CMP_J, REPS = 2000, 16
MAIN_KS, MAIN_J = (256, 1024, 2048), 100_000
POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F64_OPS_PER_S = 34e12          # H100 SXM float64 outside the tensor cores
KERNELS = {  # name -> (wrapper, TPU kernel it replaces)
    "fcfs_scan": ("fcfs_scan_fwd", "src/repro/kernels/msj_scan/kernel.py:73"),
    "modbs_scan": ("modbs_scan_fwd",
                   "src/repro/kernels/msj_scan/kernel.py:157"),
    "bs_scan": ("bs_scan_fwd", "src/repro/kernels/msj_scan/kernel.py:257"),
}
SOURCE = "src/repro_torch/kernels/msj_scan/csrc/msj_scan.cu"
SRPT_SOURCE = "src/repro_torch/kernels/msj_scan/csrc/srpt_scan.cu"
SRPT_REPLACES = "src/repro/kernels/msj_scan/srpt.py:75"
SORT_REPLACES = "src/repro/kernels/msj_scan/sort.py:58"
FIG3_KS, FIG3_J, FIG3_R, SRPT_CMP_J = (512, 1024), 15_000, 4, 1000
# burst: J of the comparison (the plain version is a Python event loop)
# and of the [time] line
SRPT_KIT_J, SRPT_BURST_CMP_J, SRPT_BURST_J, SRPT_OVF_J = 1000, 500, 1500, 300
# Q = 8192 (the slot table in global scratch): SDSC-SP2 at k = 2048, and a
# burst of this many equal arrivals at k of the same, R = 1
SRPT_Q8K_J, SRPT_WIDE_J = 500, 4200
SORT_WS, SORT_R = (4096, 3000), 4
FAIL_KERNELS = {  # name -> (wrapper, TPU kernel it replaces)
    "fcfs_fail_scan": ("fcfs_fail_scan_fwd",
                       "src/repro/kernels/msj_scan/kernel.py:110"),
    "modbs_fail_scan": ("modbs_fail_scan_fwd",
                        "src/repro/kernels/msj_scan/kernel.py:201"),
    "bs_fail_scan": ("bs_fail_scan_fwd",
                     "src/repro/kernels/msj_scan/kernel.py:316"),
}
DRAIN_KS, DRAIN_SMALL_J, DRAIN_SMALL_R = (256, 1024), 2000, 4
# J of the drain kernels' comparison with their plain versions on the card
# (4000 until the BS-pi redesign, then 2000, then 1000; cut each time to
# make room for a phase: 800 since the event-engine phase 3e, which also
# holds the three drain kernels to engine="python"; 600 since the theory
# phase 3f; 400 since the serving driver's phase)
DRAIN_CMP_J = 400
# BS-pi's adversarial cases (bench/bs_cases.ADVERSARIAL): J and R of the
# comparison with the plain version on the CPU
BS_ADV_J, BS_ADV_R = 2000, 4
# the FCFS / ModBS-pi adversarial cases (bench/fm_cases.ADVERSARIAL), the same
FM_ADV_J, FM_ADV_R = 2000, 4
# the stream path: Fig. 1's batch replayed at k and J in chunks of each
# size (the second ragged), and a generated BS-pi stream of this many
# jobs a replication (peak memory read after each)
STREAM_KS, STREAM_J, STREAM_CHUNKS = (2048, 256), 100_000, (10_000, 7_919)
STREAM_GEN_TOTALS = (200_000, 1_000_000)
# J, R and chunk of the carried kernels' comparisons with their plain
# versions on the card (BS-pi's at the stream core's default backlog_cap,
# so q_cap = backlog_cap + chunk as on the main path), and the adversarial
# cases that join Fig. 1 there
STREAM_CMP = (1000, REPS, 250)
STREAM_FM_ADV, STREAM_BS_ADV = ("bursts", "need1", "ties"), ("kit512",)
STREAM_KERNELS = {  # name -> (wrapper, the reference's stream core)
    "fcfs_stream_scan": ("fcfs_stream_fwd", "src/repro/core/sim_jax.py:160"),
    "modbs_stream_scan": ("modbs_stream_fwd",
                          "src/repro/core/sim_jax.py:312"),
    "bs_stream_scan": ("bs_stream_fwd", "src/repro/core/sim_jax.py:790"),
}
STREAM_FIELDS = ("mean_response", "var_response", "mean_wait", "var_wait",
                 "p_wait", "p_helper", "p_routed")
# the theory path: R and J of loss_scan's comparisons with its plain
# version, and the s of each (with LOSS_S_MAX, the largest the kernel
# takes); test_erlang.py's M/M/s/s (R, J, s, lambda; d = 1) against the
# heapq oracle; Property 1's Fig. 1 k (at MAIN_J, REPS); the s of the
# [time] lines; theory_tables' mc_jobs (its default)
LOSS_CMP, LOSS_SS = (4, 2000), (1, 6, 24, 196)
LOSS_MMSS = (16, 100_000, 10, 8.0)
PROP1_K, LOSS_TIME_SS, TABLES_MC_JOBS = 2048, (10, 196), 150_000


def grid_launches(tag: str, counts: dict, want: dict) -> None:
    """A path's grids launch each kernel of ``want`` that many times (one
    ``simulate_grid`` per policy) and no other msj_scan kernel."""
    got = {w: n for w, n in counts.items() if n}
    print(f"[{tag}] launches of the grid path: {got} (expected {want})")
    if got != want:
        fail(f"the {tag} path launched {got}, expected {want}")


def sweeps_equal(tag: str, a, b) -> None:
    """Two ``SweepResult`` s equal on every field but ``sim_s``."""
    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "sim_s":
            continue
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            same = (x is None) == (y is None) and (
                x is None or np.array_equal(x, y, equal_nan=True))
        else:
            same = x == y
        if not same:
            fail(f"{tag}: {f.name} of the grid sweep differs from the "
                 f"sweep cell by cell")
    print(f"[{tag}] grid sweep == cell-by-cell sweep on every field but "
          f"sim_s")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(name: str, R: int, J: int, k: int) -> tuple[float, str]:
    """Least time the card could take for one call: (ms, what bounds it).

    Bytes: every input read once and every output written once.
    Operations: the float64 maxima, additions and compares the function
    needs per event — a start time (2 maxima, 1 add) plus a binary search
    of log2(k) compares for FCFS; ModBS adds the class-row scan; BS
    decides among three candidate events per event.
    """
    log_k = max(1, (k - 1).bit_length())
    if name == "fcfs_scan":
        nbytes, ops = R * J * (8 + 4 + 8 + 8), R * J * (3 + log_k)
    elif name == "modbs_scan":
        nbytes, ops = R * J * (8 + 4 + 4 + 8 + 1 + 8), R * J * (6 + log_k)
    else:
        nbytes = R * J * (8 + 4 + 4 + 8) + R * 2 * J * (4 + 8) + R
        ops = R * 2 * J * (8 + log_k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fail_bound(name: str, R: int, J: int, k: int, events: int, F: int,
               length: int) -> tuple[float, str]:
    """Least time for one drain-mode call: (ms, what bounds it).

    Bytes: every input read once (the [R, L] merged stream, L = J + F, for
    FCFS/ModBS; the [R, J] trace and the [R, F] failure records for BS)
    and every output written once ([R, L]; BS [R, length]).  Operations:
    the per-event counts of :func:`bound` over the ``events`` this run's
    data holds, summed over the replications: J plus the replication's
    failure rows (FCFS/ModBS); 2J plus its failure events plus its
    class-targeted ones, each of which may add a repair completion (BS).
    """
    log_k = max(1, (k - 1).bit_length())
    if name == "fcfs_fail_scan":
        nbytes = R * (J + F) * (8 + 4 + 8 + 8 + 1 + 8)
        ops = events * (3 + log_k)
    elif name == "modbs_fail_scan":
        nbytes = R * (J + F) * (8 + 4 + 4 + 8 + 8 + 1 + 1 + 8)
        ops = events * (6 + log_k)
    else:
        nbytes = (R * J * (8 + 4 + 4 + 8) + R * F * (8 + 4 + 8)
                  + R * length * (4 + 8) + R)
        ops = events * (8 + log_k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def srpt_bound(R: int, J: int, job_ev) -> tuple[float, str]:
    """Least time for one srpt_scan call: (ms, what bounds it).

    Bytes: the three [R, J] float64 inputs and kk once, the three
    [R, 2J] float64 record streams and the four [R] counters once.
    Operations: what this run's data needs per event with n jobs in the
    system — the rank of each (a subtract, a subtract, a maximum and, for
    SF, a multiply: 4) and a comparison sort of the n ranks
    (n log2 n compares); n at each event is read off the run's own
    departure stream (every event is an arrival or a departure).
    """
    import numpy as np

    nbytes = R * J * 3 * 8 + R * 8 + R * 2 * J * 3 * 8 + R * (1 + 3 * 4)
    dep = (job_ev >= 0).astype(np.int64)
    n = np.cumsum(1 - 2 * dep, axis=1)          # in-system after each event
    n = np.maximum(n, 1).astype(np.float64)
    ops = float((n * (4 + np.log2(np.maximum(n, 2)))).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sort_bound(R: int, W: int, num_keys: int) -> tuple[float, str]:
    """Least time for one stable_sort call: the keys and payload read and
    written once; W log2 W float64 compares per row (a comparison sort)."""
    nbytes = 2 * R * W * (8 * num_keys + 4)
    ops = R * W * max(1.0, math.log2(W)) * num_keys
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


ATTN = {  # name -> (CUDA source, TPU kernel it replaces)
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:74"),
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:69"),
}
# H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor cores, and
# float32 outside them (the float32 kernels are held to float32 precision)
OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Kernel against plain version: |out - ref| <= atol + rtol |ref| for every
# element.  Both round one float32 result to the dtype, so in bfloat16 they
# differ by at most one unit in the last place (2^-7 |ref|); the limit
# allows two, plus the float32 sums' own difference (atol), far below what
# reading one position past pos or dropping one split moves.  float32 keeps
# tests/test_kernels.py's 2e-5
ATTN_TOLS = {"bfloat16": (1e-5, 2.0 ** -6), "float32": (2e-5, 2e-5)}
HEADS = {"yi_9b": (32, 4, 128), "stablelm_3b": (32, 32, 80),  # H, Kh, D
         "moonshot_v1_16b_a3b": (16, 16, 128),
         "jamba_1_5_large_398b": (64, 8, 128),
         # the group counts that are not a power of two: G = 9 (the
         # serving driver's starcoder-8k class) and G = 6
         "starcoder2_7b": (36, 4, 128), "internlm2_20b": (48, 8, 128)}
FLASH_S, DECODE_SK, DECODE_BS = 2048, 8192, (1, 4)
# tests/test_substrate.py's request classes: (name, arch, bucket, chips,
# mean service s, arrival mix), served at full width on the one card
SERVE_CLASSES = (("small", "stablelm_3b", 8192, 2, 1.0, 0.8),
                 ("big", "yi_9b", 8192, 8, 4.0, 0.2))
SERVE_PROMPTS, SERVE_NEW, SERVE_ARRIVALS = (512, 2048), 32, 20
GMM = ("src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
       "src/repro/kernels/moe_gmm/kernel.py:51")
# the tensor-core (wgmma) kernels beside the CUDA-core ones above: the
# wrappers route bf16 flash_attention and bf16 prefill gmm blocks there
FLASH_TC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu"
GMM_TC = "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm_tc.cu"
# the decode route of gmm: bf16 blocks of 16 or 32 rows on mma.sync
GMM_DEC = "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm_dec.cu"
# tensor-core kernels and the instruction each must contain: wgmma (HGMMA)
# or mma.sync (HMMA)
TC_KERNELS = {"flash_tc_kernel": "HGMMA", "gmm_tc_kernel": "HGMMA",
              "gmm_dec_kernel": "HMMA"}
MOE_ARCH = "moonshot_v1_16b_a3b"
MOE_CLASSES = (SERVE_CLASSES[0], ("big", MOE_ARCH, 8192, 8, 4.0, 0.2))
WKV = ("src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
       "src/repro/kernels/rwkv6/kernel.py:70")
RWKV_ARCH = "rwkv6_7b"
# WKV against its plain version: y in float32 and s_T (always float32)
# within tests/test_kernels.py's limit for the chunked form (float32 sums
# of terms up to ~100 in another order, and e^{+-c} factors that cost a
# few digits at fast decays); y in bfloat16 within that limit plus two
# units in the last place, since each side rounds its float32 y once (an
# output near zero that cancels large terms keeps the float32 sums'
# absolute difference, so the attention kernels' atol of 1e-5 does not
# hold here)
WKV_TOLS = {"bfloat16": (5e-4, 1e-3 + 2.0 ** -6), "float32": (5e-4, 1e-3)}
WKV_S, WKV_CHUNK = 2048, 64
# the edge shapes of the kernels' chunk-parallel split, at small size:
# (B, S, H, N, chunk) with S = 1, S below the chunk, N of 48 and 5, short
# chunks, B = 2
WKV_EDGE = ((1, 1, 2, 64, 64), (2, 40, 3, 48, 64), (2, 70, 2, 48, 16),
            (1, 33, 1, 5, 8))
MAMBA = ("src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
         "src/repro/kernels/mamba_scan/kernel.py:54")
HYBRID_ARCH = "jamba_1_5_large_398b"
# Selective scan against its plain version: tests/test_kernels.py's limit,
# 1e-4 + 1e-4 |ref| (float32 sums of the same terms, FMAs on the card),
# plus two units in the last place where y is bfloat16 (each side rounds
# its float32 y once)
MAMBA_TOLS = (1e-4, 1e-4)
MAMBA_S = 2048
# the fused kernel's edge shapes (B, S, d_in, N): S = 1, N not a multiple of
# its 4 states a lane, d_in not a multiple of its 32 channels a block (with
# the 16-byte copies and without), B = 2
MAMBA_EDGE = ((2, 1, 64, 16), (1, 45, 200, 7), (1, 45, 200, 12),
              (2, 33, 97, 13), (2, 77, 300, 5))
# the cross-attention and MLA serving phases: seamless-m4t-large-v2 at full
# size and llama-3.2-vision-90b cut by ``vlm_cut``, with its zero-init
# cross-attention gate set to VLM_GATE so that the cross layer adds to the
# residual (as the CPU tests set it); deepseek-v3 cut by ``mla_cut``
XATTN_ARCHS = ("seamless_m4t_large_v2", "llama_3_2_vision_90b")
VLM_GATE = 0.5
MLA_ARCH = "deepseek_v3_671b"
# MLA's teacher-forced per-layer bound: bench/decode_vs_forward.LAYER_TOL
MLA_LAYER_TOL = 2.0 ** -6
# the serving driver (launch/serve.py): run_epochs at its defaults (the
# reference's), held card == CPU bit for bit, and --execute with the
# classes its draws give at seed 0
DRIVER_KW = dict(fleet=512, epochs=4, epoch_jobs=6000, chunk_jobs=2000,
                 reps=2, load=0.8, period=3600.0, amplitude=0.5, seed=0)
# the driver's epoch loop at DRIVER_KW on the CPU, the plain versions of the
# carried kernels, for one policy (argv[1]) on one thread (their many small
# steps only slow down on more): its printed lines, history and seconds,
# pickled to stdout
PLAIN_EPOCHS = """
import json, pickle, sys, time
out, sys.stdout = sys.stdout.buffer, sys.stderr
import torch
torch.set_num_threads(1)
from repro_torch.launch import serve
pol, kw = sys.argv[1], json.loads(sys.argv[2])
lines, t0 = [], time.time()
hist = serve.run_epochs(serve.default_classes(kw["fleet"], "cpu"),
                        policy=pol, device="cpu", out=lines.append, **kw)
out.write(pickle.dumps((lines, hist, time.time() - t0)))
"""
DRIVER_EXECUTE = 5
DRIVER_DRAWS = ["starcoder-8k", "deepseek-32k", "yi9b-8k", "deepseek-32k",
                "yi9b-8k"]


def _roofline(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_bound(B, Sq, Sk, H, Kh, D, Dv, causal, dtype):
    """Least time for one flash_attention call: q, k, v read once and o
    written once; 2 (D + Dv) flops for each (query, key) pair the mask
    keeps (causal: key <= query), at the dtype's peak."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (B * Sq * H * (D + Dv) + B * Sk * Kh * (D + Dv))
    if not causal:
        kept = Sq * Sk
    elif Sq <= Sk:
        kept = Sq * (Sq + 1) // 2
    else:
        kept = Sk * (Sk + 1) // 2 + (Sq - Sk) * Sk
    return _roofline(nbytes, 2 * B * H * kept * (D + Dv), dtype)


def decode_bound(H, Kh, D, Dv, Sk, pos, dtype):
    """Least time for one decode_attention call: q read and o written
    once, and each cache row this run's ``pos`` keeps (positions <= pos)
    read once; 2 (D + Dv) flops per kept row and query head."""
    item = 2 if dtype == "bfloat16" else 4
    B = len(pos)
    rows = sum(Sk if p < 0 else min(p + 1, Sk) for p in pos)
    nbytes = item * (B * H * (D + Dv) + rows * Kh * (D + Dv)) + 4 * B
    return _roofline(nbytes, 2 * H * (D + Dv) * rows, dtype)


def serving_path(dev) -> dict:
    """The LLM serving path: the two attention kernels against their plain
    versions at the served models' shapes, ``ServingEngine`` at the full
    width of stablelm-3b and yi-9b with the launch counts set to 0 just
    before and read just after, card == CPU on a reduced float32 engine,
    and the kernels' times.  Returns the two kernels' report entries."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_cache
    from repro_torch.serve import engine as E

    # float32 matmuls in full float32 (PyTorch's default, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(
            getattr(torch, dtype))

    def check(name, out, ref, dtype, what):
        atol, rtol = ATTN_TOLS[dtype]
        ref = ref.float()
        d = (out.float() - ref).abs()
        err = d.max().item()
        worst = (d / (atol + rtol * ref.abs())).max().item()
        print(f"[kernel] {name} {what}: max abs err {err:.3g}; limit "
              f"{atol:g} + {rtol:g} |ref| per element, largest err/limit "
              f"{worst:.3g}; mean |ref| {ref.abs().mean().item():.3g}")
        if not worst <= 1.0:
            fail(f"{name} {what} differs from its plain version: max abs "
                 f"err {err}, largest err/limit {worst}")
        return err

    # -- [kernel] flash_attention: B = 1, S = 2048, causal ------------------
    flash_cases = []
    for arch, dtype in ([(a, "bfloat16") for a in HEADS]
                        + [(a, "float32") for a in HEADS]):
        H, Kh, D = HEADS[arch]
        q = randn(1, FLASH_S, H, D, dtype=dtype)
        k = randn(1, FLASH_S, Kh, D, dtype=dtype)
        v = randn(1, FLASH_S, Kh, D, dtype=dtype)
        out = flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        route = flash_attention_fwd.last_route
        what = (f"{arch} B=1 S={FLASH_S} H={H} Kh={Kh} D={D} {dtype} causal, "
                f"{route} kernel")
        err = check("flash_attention", out, flash_attention_ref(
            q, k, v, causal=True), dtype, what)
        if route != ("wgmma" if dtype == "bfloat16" else "simt"):
            fail(f"flash_attention {what}: a {dtype} call took the {route} "
                 f"kernel")
        flash_cases.append(dict(arch=arch, dtype=dtype, what=what, err=err,
                                kernel_route=route, args=(q, k, v),
                                shape=(1, FLASH_S, FLASH_S, H, Kh, D, D)))

    # -- [kernel] decode_attention: B in {1, 4}, Sk = 8192, random pos ------
    decode_cases = []
    for arch, B, dtype in ([(a, b, "bfloat16") for a in HEADS
                            for b in DECODE_BS]
                           + [(a, 4, "float32") for a in HEADS]):
        H, Kh, D = HEADS[arch]
        q = randn(B, H, D, dtype=dtype)
        k = randn(B, DECODE_SK, Kh, D, dtype=dtype)
        v = randn(B, DECODE_SK, Kh, D, dtype=dtype)
        pos = torch.randint(0, DECODE_SK, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        what = (f"{arch} B={B} Sk={DECODE_SK} H={H} Kh={Kh} D={D} {dtype} "
                f"pos={pos.tolist()}")
        out = decode_attention_fwd(q, k, v, pos)
        torch.cuda.synchronize()
        err = check("decode_attention", out,
                    decode_attention_ref(q, k, v, pos), dtype, what)
        decode_cases.append(dict(arch=arch, dtype=dtype, what=what, err=err,
                                 args=(q, k, v, pos)))

    # -- [serve] ServingEngine at full width ---------------------------------
    classes = [E.RequestClass(n, get_config(a), b, c, s, al)
               for n, a, b, c, s, al in SERVE_CLASSES]
    eng = E.ServingEngine(classes, fleet_chips=64, seed=0, device=dev)
    eng.partition.validate()
    rng = np.random.default_rng(5)
    for i in range(SERVE_ARRIVALS):
        name = "small" if i % 5 else "big"
        S = SERVE_PROMPTS[i % 2]
        eng.submit(E.Request(rid=i, cls_name=name, prompt=rng.integers(
            1, eng._model(name).cfg.vocab_size, S),
            max_new_tokens=SERVE_NEW), now=float(i) * 0.01)
    print(f"[serve] {eng.partition.summary()}".replace("\n", "\n[serve] "))
    print(f"[serve] after {SERVE_ARRIVALS} arrivals: metrics {eng.metrics}, "
          f"p_helper {eng.p_helper:.6f}, running {len(eng.sched.running)}, "
          f"waiting on the helper {len(eng.sched.helper_wait)}")
    runs = {}
    for jid in sorted(eng.sched.running):
        req = eng._jobs[jid]
        runs.setdefault((req.cls_name, len(req.prompt)), jid)
    if len(runs) != 4:
        fail(f"admitted requests do not cover both classes at prompts "
             f"{SERVE_PROMPTS}: {sorted(runs)}")
    t0 = time.time()
    for name, *_ in SERVE_CLASSES[::-1]:
        eng._get_params(name)             # weights on the card: set-up
    torch.cuda.synchronize()
    gb = torch.cuda.memory_allocated() / 1e9
    print(f"[serve] weights made on the card in bfloat16 in "
          f"{time.time() - t0:.1f} s; {gb:.2f} GB allocated")
    flash_attention_fwd.launches = decode_attention_fwd.launches = 0
    t0 = time.time()
    walls = {}
    for key, jid in sorted(runs.items()):
        t1 = time.time()
        req = eng.run_request(jid)
        torch.cuda.synchronize()
        walls[key] = time.time() - t1
        vocab = eng._model(req.cls_name).cfg.vocab_size
        if len(req.output) != SERVE_NEW or not all(
                0 <= t < vocab for t in req.output):
            fail(f"request {req.rid} ({key}) gave tokens {req.output}")
        print(f"[serve] request {req.rid} class {key[0]} prompt {key[1]}: "
              f"{SERVE_NEW} tokens in {walls[key]:.3f} s, first "
              f"{req.output[:8]}")
    counts = {"flash_attention": flash_attention_fwd.launches,
              "decode_attention": decode_attention_fwd.launches}
    layers = {n: eng._model(n).cfg.num_layers for n, *_ in SERVE_CLASSES}
    want = {"flash_attention": sum(layers[n] for n, _ in runs),
            "decode_attention": sum(layers[n] * (SERVE_NEW - 1)
                                    for n, _ in runs)}
    print(f"[serve] {len(runs)} requests end to end in "
          f"{time.time() - t0:.1f} s; launches {counts} (expected {want}: "
          f"L per prefill, L per generated token after the first)")
    if counts != want or min(counts.values()) < 1:
        fail(f"launch counts {counts} differ from {want}")
    for key, jid in sorted(runs.items()):
        eng.complete(jid, 1.0)
    print(f"[serve] after completing them: metrics {eng.metrics}, p_helper "
          f"{eng.p_helper:.6f}, mean wait {eng.mean_wait():.6f}")

    # per-request prefill and per-token decode wall time (host clock around
    # work that ends in a synchronise), and decode-vs-forward at full width
    for name, arch, *_ in SERVE_CLASSES:
        model, params = eng._model(name), eng._params[name]
        cfg = model.cfg
        toks = torch.tensor(rng.integers(1, cfg.vocab_size,
                                         max(SERVE_PROMPTS)), device=dev)
        for S in SERVE_PROMPTS:
            torch.cuda.synchronize()
            t1 = time.time()
            logits, pre = model.prefill(params, {"tokens": toks[None, :S]})
            torch.cuda.synchronize()
            t_pre = time.time() - t1
            caches = E._seed_caches(init_cache(cfg, 1, S + SERVE_NEW,
                                               device=dev), pre, S)
            tok = logits.argmax(-1)[:, None]
            t1 = time.time()
            for t in range(S, S + SERVE_NEW - 1):
                logits, caches = model.decode_step(params, caches, tok, t)
                tok = logits.argmax(-1)[:, None]
            torch.cuda.synchronize()
            t_dec = (time.time() - t1) / (SERVE_NEW - 1)
            if not torch.isfinite(logits).all():
                fail(f"{arch} non-finite logits")
            print(f"[serve] {arch} ({cfg.num_layers} layers, d={cfg.d_model}"
                  f"): prefill of {S} tokens {t_pre * 1e3:.1f} ms, decode "
                  f"{t_dec * 1e3:.2f} ms per token")
        S = SERVE_PROMPTS[0] - 1
        kept = []                       # each layer's flash call, kept
        with dvf.keep_flash_calls(kept):
            full, _ = model.prefill(params, {"tokens": toks[None, :S + 1]})
        # [kernel] flash_attention on that prefill's own q, k, v, layer by
        # layer: the served models' large, near-tied scores
        worst = {"wgmma": (0.0, -1), "simt": (0.0, -1)}
        for i, (q, k, v, out, route, _) in enumerate(kept):
            ref = flash_attention_ref(q, k, v, causal=True)
            for name, o in ((route, out), ("simt", flash_kernel._launch(
                    q, k, v, True, "simt"))):
                worst[name] = max(worst.get(name, (0.0, -1)),
                                  (dvf.err_over_limit(o, ref), i))
        routes = sorted({c[4] for c in kept})
        print(f"[kernel] flash_attention {arch} prefill({S + 1})'s own q, k, "
              f"v in each of its {len(kept)} layers ({tuple(kept[0][0].shape)}"
              f" bfloat16, causal, route {routes}) against the plain version:"
              f" largest err/limit {worst['wgmma'][0]:.3g} (layer "
              f"{worst['wgmma'][1]}); the simt kernel on the same inputs "
              f"{worst['simt'][0]:.3g} (layer {worst['simt'][1]})")
        if routes != ["wgmma"] or len(kept) != cfg.num_layers:
            fail(f"{arch}: {len(kept)} flash calls on routes {routes} in a "
                 f"prefill of {cfg.num_layers} layers")
        if not worst["wgmma"][0] <= 1.0:
            fail(f"flash_attention on {arch}'s layers differs from its plain "
                 f"version: err/limit {worst['wgmma'][0]} in layer "
                 f"{worst['wgmma'][1]}")
        del kept
        _, pre = model.prefill(params, {"tokens": toks[None, :S]})
        caches = E._seed_caches(init_cache(cfg, 1, S + 8, device=dev), pre, S)
        step, _ = model.decode_step(params, caches, toks[None, S:S + 1], S)
        diff = (full.float() - step.float()).abs().max().item()
        if not (torch.isfinite(full).all() and torch.isfinite(step).all()):
            fail(f"{arch}: non-finite logits")
        print(f"[serve] {arch} decode-vs-forward, free running: prefill({S}) "
              f"+ decode vs prefill({S + 1}) last logits max abs diff "
              f"{diff:.4f}; largest logit {full.float().abs().max().item():.3f}"
              f" (printed, not held: at the reference's init one bf16 unit "
              f"between the flash and decode kernels' last row moves the "
              f"logits by units, with the simt flash kernel too; "
              f"bench/decode_vs_forward.py)")
        rel = dvf.layer_by_layer(model, params, toks, S)
        worst_l = max(range(len(rel)), key=rel.__getitem__)
        print(f"[serve] {arch} decode-vs-forward, layer by layer: decode at "
              f"token {S} after prefill({S}), each layer fed prefill({S + 1})"
              f"'s input there, against prefill({S + 1})'s output: largest "
              f"|diff| / max |row| {rel[worst_l]:.5f} (layer {worst_l} of "
              f"{len(rel)}; bound {dvf.LAYER_TOL:g})")
        if len(rel) != cfg.num_layers or not rel[worst_l] <= dvf.LAYER_TOL:
            fail(f"{arch} decode-vs-forward layer {worst_l}: {rel[worst_l]} "
                 f"> {dvf.LAYER_TOL}")

    # card == CPU: a reduced float32 engine with the same weights
    small = [E.RequestClass(n, dataclasses.replace(
        get_config(a), compute_dtype="float32").reduced(), b, c, s, al)
        for n, a, b, c, s, al in SERVE_CLASSES]
    on_cpu = E.ServingEngine(small, fleet_chips=64, seed=0, device="cpu")
    on_card = E.ServingEngine(small, fleet_chips=64, seed=0, device=dev)
    for name, *_ in SERVE_CLASSES:
        on_card._params[name] = tree_map(lambda t: t.to(dev),
                                         on_cpu._get_params(name))
    rng_small = np.random.default_rng(6)
    for i in range(SERVE_ARRIVALS):
        name = "small" if i % 5 else "big"
        prompt = rng_small.integers(1, 512, (64, 128)[i % 2])
        for e in (on_cpu, on_card):
            e.submit(E.Request(rid=i, cls_name=name, prompt=prompt,
                               max_new_tokens=8), now=float(i) * 0.01)
    n_cmp = 0
    for jid in sorted(on_cpu.sched.running):
        a = on_cpu.run_request(jid).output
        b = on_card.run_request(jid).output
        if a != b:
            fail(f"reduced float32 engine: request {jid} gives {b} on the "
                 f"card and {a} on the CPU")
        n_cmp += 1
    print(f"[serve] reduced float32 engines (stablelm/yi smoke configs, "
          f"prompts 64/128, 8 tokens): card == CPU token for token on all "
          f"{n_cmp} admitted requests; metrics equal: "
          f"{on_card.metrics == on_cpu.metrics}")
    if on_card.metrics != on_cpu.metrics:
        fail("reduced engines: admission metrics differ")

    # -- [time] each kernel at the [kernel] shapes ---------------------------
    report = {}
    for c in flash_cases:
        q, k, v = c["args"]
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True), 5)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                           3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5)
        b_ms, b_by = flash_bound(*c["shape"], True, c["dtype"])
        c.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by)
        simt = ""
        if c["kernel_route"] == "wgmma":   # the CUDA-core kernel it replaced
            c["simt_ms"] = cuda_ms(lambda: flash_kernel._launch(
                q, k, v, True, "simt"), 3)
            simt = f", the simt kernel on the same call {c['simt_ms']:.4f} ms"
        print(f"[time] flash_attention {c['what']}: {ms:.4f} ms per launch, "
              f"plain version {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}){simt}")
    for c in decode_cases:
        q, k, v, pos = c["args"]
        B, H, D = q.shape
        Kh = k.shape[2]
        ms = cuda_ms(lambda: decode_attention_fwd(q, k, v, pos), 20)
        plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, pos), 5)
        mask = (torch.arange(DECODE_SK, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), 20)
        b_ms, b_by = decode_bound(H, Kh, D, D, DECODE_SK, pos.tolist(),
                                  c["dtype"])
        c.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by)
        print(f"[time] decode_attention {c['what']}: {ms:.4f} ms per launch "
              f"({b_ms / ms:.3f} of the {b_by} bound), plain version "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by})")
    for name, cases in (("flash_attention", flash_cases),
                        ("decode_attention", decode_cases)):
        top = cases[0]                  # yi-9b, bfloat16 (B = 1 for decode)
        report[name] = dict(
            name=name, route="cuda",
            source=FLASH_TC if name == "flash_attention" else ATTN[name][0],
            replaces=ATTN[name][1], launches=counts[name],
            max_abs_err=max(c["err"] for c in cases), ms=top["ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            shape=top["what"],
            configs=[{k: v for k, v in c.items() if k != "args"}
                     for c in cases])
    report["flash_attention"]["sources"] = {
        "wgmma": FLASH_TC, "simt": ATTN["flash_attention"][0]}
    report["flash_attention"]["serve_walls_s"] = {
        f"{n} {S}": w for (n, S), w in sorted(walls.items())}
    return report


def gmm_want_route(dtype: str, block_m: int) -> str:
    """The route a gmm case at the served shapes (K and N multiples of 8)
    must take: bf16 prefill blocks ``wgmma``, bf16 decode blocks ``mma``,
    float32 ``simt``."""
    if dtype != "bfloat16":
        return "simt"
    return "wgmma" if block_m % 64 == 0 else "mma"


def gmm_bound(rows, experts, M, K, N, nblocks, dtype):
    """Least time for one gmm call: the x rows of valid blocks and the
    weights of the valid experts read once, the whole [M, N] output and
    the two [nblocks] int32 maps written / read once; 2 K N flops per row
    of a valid block, at the dtype's peak."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (rows * K + experts * K * N + M * N) + 8 * nblocks
    return _roofline(nbytes, 2 * rows * K * N, dtype)


def gmm_vs_plain(out, x, w, be, nv, bm) -> tuple[float, float, bool]:
    """``out = gmm(x, w, be, nv, block_m=bm)`` against the plain version,
    one expert with valid rows at a time (the buffer is expert-major, Cp
    rows an expert; a float32 gather of a whole expert stack can take 15
    GB), at the bf16 limit: (largest err/limit, largest abs err, skipped
    blocks exactly zero)."""
    import torch

    from repro_torch.kernels.moe_gmm import gmm_ref

    E = w.shape[0]
    Cp = x.shape[0] // E
    nb = Cp // bm
    atol, rtol = ATTN_TOLS["bfloat16"]
    worst = err = 0.0
    for e in torch.nonzero(nv.view(E, nb).sum(1) > 0).flatten().tolist():
        sl, bs = slice(e * Cp, (e + 1) * Cp), slice(e * nb, (e + 1) * nb)
        ref = gmm_ref(x[sl], w[e:e + 1], torch.zeros_like(be[bs]),
                      nv[bs].contiguous(), block_m=bm).float()
        d = (out[sl].float() - ref).abs()
        err = max(err, d.max().item())
        worst = max(worst, (d / (atol + rtol * ref.abs())).max().item())
        del ref, d
    skipped = (nv == 0).repeat_interleave(bm)
    return worst, err, bool((out[skipped] == 0).all())


def admitted_big_runs(classes, tag: str, dev):
    """A ``ServingEngine`` on ``dev`` over ``classes`` ("small" and
    "big"), the serving phases' arrivals (every 5th one "big", prompts
    alternating over SERVE_PROMPTS, SERVE_NEW tokens each), with the
    partition and the admission metrics printed under ``[tag]``.  Returns
    (engine, {prompt length: jid} of one admitted "big" request per
    prompt length, the arrivals' generator)."""
    import numpy as np

    from repro_torch.serve import engine as E

    eng = E.ServingEngine(classes, fleet_chips=64, seed=0, device=dev)
    eng.partition.validate()
    rng = np.random.default_rng(5)
    for i in range(SERVE_ARRIVALS):
        name = "small" if i % 5 else "big"
        S = SERVE_PROMPTS[i % 2]
        eng.submit(E.Request(rid=i, cls_name=name, prompt=rng.integers(
            1, eng._model(name).cfg.vocab_size, S),
            max_new_tokens=SERVE_NEW), now=float(i) * 0.01)
    print(f"[{tag}] {eng.partition.summary()}".replace("\n", f"\n[{tag}] "))
    print(f"[{tag}] after {SERVE_ARRIVALS} arrivals: metrics {eng.metrics}, "
          f"p_helper {eng.p_helper:.6f}, running {len(eng.sched.running)}, "
          f"waiting on the helper {len(eng.sched.helper_wait)}")
    runs = {}
    for jid in sorted(eng.sched.running):
        req = eng._jobs[jid]
        if req.cls_name == "big":
            runs.setdefault(len(req.prompt), jid)
    if sorted(runs) != sorted(SERVE_PROMPTS):
        fail(f"[{tag}] admitted big requests do not cover prompts "
             f"{SERVE_PROMPTS}: {sorted(runs)}")
    return eng, runs, rng


def card_equals_cpu(classes, tag: str, big_prompts, kernel, dev) -> None:
    """card == CPU: ``classes`` (reduced float32 configs) served by an
    engine on the CPU and one on ``dev`` given the CPU engine's weights,
    with the same 20 arrivals (prompts 64 / 128 for "small",
    ``big_prompts`` for "big", 8 tokens each).  Fails unless every
    admitted request gives the same tokens on both, the admission metrics
    are equal and the card ran a "big" request through ``kernel`` (a
    wrapper with a launch count)."""
    import numpy as np

    from repro_torch.models.layers import tree_map
    from repro_torch.serve import engine as E

    on_cpu = E.ServingEngine(classes, fleet_chips=64, seed=0, device="cpu")
    on_card = E.ServingEngine(classes, fleet_chips=64, seed=0, device=dev)
    for c in classes:
        on_card._params[c.name] = tree_map(lambda t: t.to(dev),
                                           on_cpu._get_params(c.name))
    rng = np.random.default_rng(6)
    for i in range(SERVE_ARRIVALS):
        name = "small" if i % 5 else "big"
        prompt = rng.integers(1, 512, ((64, 128) if name == "small"
                                       else big_prompts)[i % 2])
        for e in (on_cpu, on_card):
            e.submit(E.Request(rid=i, cls_name=name, prompt=prompt,
                               max_new_tokens=8), now=float(i) * 0.01)
    n_cmp, n_big = 0, 0
    before = kernel.launches
    for jid in sorted(on_cpu.sched.running):
        a = on_cpu.run_request(jid).output
        b = on_card.run_request(jid).output
        if a != b:
            fail(f"[{tag}] reduced float32 engine: request {jid} gives {b} "
                 f"on the card and {a} on the CPU")
        n_cmp += 1
        n_big += on_cpu._jobs[jid].cls_name == "big"
    print(f"[{tag}] reduced float32 engines ({classes[0].cfg.name} / "
          f"{classes[1].cfg.name}, prompts 64/128, big "
          f"{big_prompts[0]}/{big_prompts[1]}, 8 tokens): card == CPU token "
          f"for token on all {n_cmp} admitted requests ({n_big} big, "
          f"{kernel.launches - before} {kernel.__name__} launches on the "
          f"card); metrics equal: {on_card.metrics == on_cpu.metrics}")
    if n_big < 1 or kernel.launches == before:
        fail(f"[{tag}] the reduced engines ran no big request on the card")
    if on_card.metrics != on_cpu.metrics:
        fail(f"[{tag}] reduced engines: admission metrics differ")


class KeptMoEInputs:
    """While active (``with``), keeps each prefill's MoE layer inputs
    (``models.moe.moe_ffn`` wrapped; one token is not kept) so that
    :meth:`drops` can route them again after the pass."""

    def __init__(self, moe, m):
        self.moe, self.m, self.saved = moe, m, []

    def __enter__(self):
        ffn = self.ffn = self.moe.moe_ffn

        def keep(x, params, cfg, **kw):
            if x.shape[0] * x.shape[1] > 1:
                self.saved.append((x, params["router"]))
            return ffn(x, params, cfg, **kw)

        self.moe.moe_ffn = keep
        return self

    def __exit__(self, *exc):
        self.moe.moe_ffn = self.ffn

    def drops(self, held: int):
        """(pairs dropped at capacity over the kept layers, of them the
        last token's, pairs routed to experts at or past ``held``, which a
        card holding experts [0, held) skips); forgets the kept inputs.
        Each kept input is one router chunk (T <= 4096)."""
        moe, m = self.moe, self.m
        total = last = absent = 0
        for x, w in self.saved:
            T = x.shape[0] * x.shape[1]
            _, e, _ = moe.route(x.reshape(T, -1), w, m, with_aux=False)
            flat_e, _, d, _ = moe._positions(e, m.num_experts,
                                             moe._capacity(m, T))
            total += int(d.sum())
            last += int(d.reshape(T, m.top_k)[-1].sum())
            absent += int(((flat_e >= held) & ~d).sum())
        self.saved.clear()
        return total, last, absent

    def last_token_drops(self, held: int) -> list:
        """Each kept input's last token's dropped (token, slot) pairs, in
        the order kept (the kept inputs are kept)."""
        moe, m = self.moe, self.m
        out = []
        for x, w in self.saved:
            T = x.shape[0] * x.shape[1]
            _, e, _ = moe.route(x.reshape(T, -1), w, m, with_aux=False)
            d = moe._positions(e, m.num_experts, moe._capacity(m, T))[2]
            out.append(int(d.reshape(T, m.top_k)[-1].sum()))
        return out


def moe_path(dev) -> dict:
    """The MoE serving path: ``gmm`` against its plain version at
    moonshot-v1-16b-a3b's prefill and decode shapes (and timed there),
    ``ServingEngine`` at moonshot's full width and depth with the launch
    counts set to 0 just before and read just after, decode-vs-forward
    with the drop counts, and card == CPU on a reduced float32 engine.
    Returns the gmm report entry."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref, pad_groups
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.models import moe
    from repro_torch.models.model import init_cache
    from repro_torch.serve import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    print(f"[serve-moe] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated on entry (the dense phase's weights freed)")
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    D, F_ = cfg.d_model, m.d_ff_expert
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev).manual_seed(13)

    # -- [kernel] / [time] gmm at moonshot's prefill and decode shapes ------
    # (the [serve-moe] prefills of 2048 and 512 tokens, and one token)
    T_pre, T_512 = max(SERVE_PROMPTS), min(SERVE_PROMPTS)
    caps = {"prefill": moe._capacity(m, T_pre), "decode": moe._capacity(m, 1),
            "prefill512": moe._capacity(m, T_512)}

    def skewed_fill(T):
        pairs = rng.multinomial(T * m.top_k, rng.dirichlet(
            np.full(m.num_experts, 2.0)))
        pairs[:4] = 0                              # some experts get nothing
        return np.minimum(pairs, moe._capacity(m, T))

    fills = {"prefill": skewed_fill(T_pre),
             "decode": np.zeros(m.num_experts, np.int64)}
    fills["decode"][rng.choice(m.num_experts, m.top_k, replace=False)] = 1
    fills["prefill512"] = skewed_fill(T_512)
    cases = []
    for phase in ("prefill", "prefill512", "decode"):
        C = caps[phase]
        bm = moe.block_m_for(C)
        Cp = (C + bm - 1) // bm * bm
        be, nv = moe._fill_blocks(torch.tensor(fills[phase], device=dev), C,
                                  bm)
        # pad_groups' static counts: every block of every expert valid
        _, _, nv_static = pad_groups(torch.zeros(m.num_experts, C, 1,
                                                 device=dev), bm)
        valid = (nv > 0).cpu().numpy()
        rows = int(valid.sum()) * bm
        experts = len(set(be.cpu().numpy()[valid].tolist()))
        for proj, K, N in (("gate/up", D, F_), ("down", F_, D)):
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                # junk in every row (padding rows and empty blocks too)
                x = torch.randn(m.num_experts * Cp, K, generator=gen,
                                device=dev).to(dt)
                w = (torch.randn(m.num_experts, K, N, generator=gen,
                                 device=dev) / math.sqrt(K)).to(dt)
                out = gmm(x, w, be, nv, block_m=bm)
                torch.cuda.synchronize()
                route = gmm.last_route
                what = (f"{phase} {proj} E={m.num_experts} C={C} Cp={Cp} "
                        f"block_m={bm} K={K} N={N} {dtype}: "
                        f"{int(valid.sum())} of {len(valid)} blocks valid, "
                        f"{route} kernel")
                if route != gmm_want_route(dtype, bm):
                    fail(f"gmm {what}: took the {route} kernel, not "
                         f"{gmm_want_route(dtype, bm)}")
                ref = gmm_ref(x, w, be, nv, block_m=bm)
                atol, rtol = ATTN_TOLS[dtype]
                d = (out.float() - ref.float()).abs()
                err = d.max().item()
                worst = (d / (atol + rtol * ref.float().abs())).max().item()
                skipped = (nv == 0).repeat_interleave(bm)
                zeros = bool((out[skipped] == 0).all())
                print(f"[kernel] gmm {what}: max abs err {err:.3g}; limit "
                      f"{atol:g} + {rtol:g} |ref| per element, largest "
                      f"err/limit {worst:.3g}; mean |ref| "
                      f"{ref.float().abs().mean().item():.3g}; skipped "
                      f"blocks exactly zero: {zeros}")
                if not (worst <= 1.0 and zeros):
                    fail(f"gmm {what} differs from its plain version: max "
                         f"abs err {err}, largest err/limit {worst}, "
                         f"skipped blocks zero {zeros}")
                del ref, d
                ms = cuda_ms(lambda: gmm(x, w, be, nv, block_m=bm), 10)
                plain_ms = cuda_ms(lambda: gmm_ref(x, w, be, nv, block_m=bm),
                                   3)
                static_ms = cuda_ms(lambda: gmm(x, w, be, nv_static,
                                                block_m=bm), 10)
                xb = x.view(m.num_experts, Cp, K)
                lib_ms = cuda_ms(lambda: torch.bmm(xb, w), 10)
                b_ms, b_by = gmm_bound(rows, experts, x.shape[0], K, N,
                                       len(valid), dtype)
                case = dict(what=what, dtype=dtype, kernel_route=route,
                            err=err, err_over_limit=worst, ms=ms,
                            static_ms=static_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
                simt = ""
                if route != "simt":        # the CUDA-core kernel it replaced
                    case["simt_ms"] = cuda_ms(lambda: gmm_kernel._launch(
                        x, w, be, nv, bm, "simt"), 10 if bm % 64 else 3)
                    simt = (f", the simt kernel on the same call "
                            f"{case['simt_ms']:.4f} ms")
                print(f"[time] gmm {what}: {ms:.4f} ms per launch "
                      f"({b_ms / ms:.3f} of the {b_by} bound; "
                      f"{static_ms:.4f} ms with pad_groups' static counts, "
                      f"every block valid), plain version {plain_ms:.4f} "
                      f"ms, torch.bmm over the [E, Cp, K] buffer "
                      f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}){simt}")
                cases.append(case)
                del x, w, out, xb
    torch.cuda.empty_cache()

    # -- [serve-moe] ServingEngine at moonshot's full width and depth -------
    classes = [E.RequestClass(n, get_config(a), b, c, s, al)
               for n, a, b, c, s, al in MOE_CLASSES]
    eng, runs, rng_s = admitted_big_runs(classes, "serve-moe", dev)
    model = eng._model("big")
    cfg, m = model.cfg, model.cfg.moe
    t0 = time.time()
    params = eng._get_params("big")            # weights on the card: set-up
    torch.cuda.synchronize()
    print(f"[serve-moe] {MOE_ARCH} weights made on the card in bfloat16 in "
          f"{time.time() - t0:.1f} s: {cfg.num_params() / 1e9:.2f} B params "
          f"({cfg.active_params() / 1e9:.2f} B active per token), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    L = cfg.num_layers

    # dropped (token, slot) pairs: each prefill's MoE layer inputs are kept
    # and routed again after the pass.  One token never drops: its top-k
    # experts are distinct and C >= top-k
    if moe._capacity(m, 1) < m.top_k:
        fail(f"decode capacity {moe._capacity(m, 1)} < top-k {m.top_k}")
    with KeptMoEInputs(moe, m) as kept:
        gmm.launches = flash_attention_fwd.launches = 0
        decode_attention_fwd.launches = 0
        t0 = time.time()
        walls = {}
        for S, jid in sorted(runs.items()):
            req = eng.run_request(jid)
            torch.cuda.synchronize()
            dropped = kept.drops(m.num_experts)[0]
            if len(req.output) != SERVE_NEW or not all(
                    0 <= t < cfg.vocab_size for t in req.output):
                fail(f"moonshot request {req.rid} (prompt {S}) gave tokens "
                     f"{req.output}")
            walls[S] = (req.prefill_s, req.decode_s / (SERVE_NEW - 1))
            print(f"[serve-moe] request {req.rid} prompt {S}: prefill "
                  f"{req.prefill_s * 1e3:.1f} ms to the first token, decode "
                  f"{walls[S][1] * 1e3:.2f} ms per token; {dropped} of "
                  f"{S * m.top_k * L} (token, slot) pairs dropped in "
                  f"prefill (C = {moe._capacity(m, S)}); first tokens "
                  f"{req.output[:8]}")
        counts = {"gmm": gmm.launches,
                  "flash_attention": flash_attention_fwd.launches,
                  "decode_attention": decode_attention_fwd.launches}
        n = len(runs)
        want = {"gmm": 3 * L * n * SERVE_NEW, "flash_attention": L * n,
                "decode_attention": L * n * (SERVE_NEW - 1)}
        print(f"[serve-moe] {n} moonshot requests end to end in "
              f"{time.time() - t0:.1f} s; launches {counts} (expected "
              f"{want}: gmm 3 L per prefill and per token after the first, "
              f"flash L per prefill, decode L per token after the first)")
        if counts != want:
            fail(f"moe launch counts {counts} differ from {want}")
        for jid in runs.values():
            eng.complete(jid, 1.0)

        # decode-vs-forward at full width, with the pairs each pass dropped
        toks = torch.tensor(rng_s.integers(1, cfg.vocab_size,
                                           SERVE_PROMPTS[0]), device=dev)
        S = SERVE_PROMPTS[0] - 1
        drops = {}
        full, _ = model.prefill(params, {"tokens": toks[None, :S + 1]})
        drops[S + 1], last, _ = kept.drops(m.num_experts)
        _, pre = model.prefill(params, {"tokens": toks[None, :S]})
        drops[S] = kept.drops(m.num_experts)[0]
    caches = E._seed_caches(init_cache(cfg, 1, S + 8, device=dev), pre, S)
    step, _ = model.decode_step(params, caches, toks[None, S:S + 1], S)
    if not (torch.isfinite(full).all() and torch.isfinite(step).all()):
        fail(f"{MOE_ARCH}: non-finite logits")
    diff = (full.float() - step.float()).abs().max().item()
    dropless = drops[S] == drops[S + 1] == 0
    print(f"[serve-moe] {MOE_ARCH} decode-vs-forward: prefill({S}) + decode "
          f"vs prefill({S + 1}) last logits max abs diff {diff:.4f}; largest "
          f"logit {full.float().abs().max().item():.3f}; pairs dropped: "
          f"prefill({S}) {drops[S]}, prefill({S + 1}) {drops[S + 1]} (its "
          f"last token {last}), decode 0 (C = {moe._capacity(m, 1)} >= top-k)")
    if dropless:
        print("[serve-moe] no pass dropped a pair: held to 0.25")
        if not diff < 0.25:
            fail(f"{MOE_ARCH} decode-vs-forward diff {diff} >= 0.25")
    else:
        print(f"[serve-moe] not held to 0.25: at capacity factor "
              f"{m.capacity_factor} a {S + 1}-token prefill has C = "
              f"{moe._capacity(m, S + 1)} rows per expert and drops pairs "
              f"that decode (C = {moe._capacity(m, 1)} for one token's "
              f"{m.top_k}) keeps, so the two passes compute different "
              f"functions, on the reference too")
    print(f"[serve-moe] peak memory in the phase "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")
    del eng, params, model, caches, pre
    torch.cuda.empty_cache()

    # card == CPU: a reduced float32 engine with the same weights
    card_equals_cpu([E.RequestClass(n, dataclasses.replace(
        get_config(a), compute_dtype="float32").reduced(), b, c, s, al)
        for n, a, b, c, s, al in MOE_CLASSES], "serve-moe", (64, 128), gmm,
        dev)

    top = cases[0]                    # prefill gate/up, bfloat16
    return {"gmm": dict(
        name="gmm", route="cuda", source=GMM_TC,
        sources={"wgmma": GMM_TC, "mma": GMM_DEC, "simt": GMM[0]},
        replaces=GMM[1],
        launches=counts["gmm"], max_abs_err=max(c["err"] for c in cases),
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=top["library_ms"],
        shape=top["what"], configs=cases,
        moe_launches={k: v for k, v in counts.items() if k != "gmm"},
        serve_s={f"prompt {S}": {"prefill": p, "decode_per_token": d}
                 for S, (p, d) in sorted(walls.items())})}


def wkv_bound(B, S, H, N, chunk, dtype):
    """Least time for one wkv call: r / k / v read in their dtype, logw,
    u and s0 read once in float32, y written in r's dtype and s_T in
    float32; per chunk of Tc steps and head, 2 Tc N^2 flops each for
    r_dec S and the state update and Tc (Tc + 1) N each for the causal
    scores (diagonal included) and their product with v, at the float32
    CUDA-core peak (the function is float32 arithmetic in both dtypes)."""
    item = 2 if dtype == "bfloat16" else 4
    elems = B * S * H * N
    nbytes = item * 4 * elems + 4 * elems + 4 * H * N + 4 * 2 * B * H * N * N
    ops = 0
    for c0 in range(0, S, chunk):
        Tc = min(chunk, S - c0)
        ops += 4 * Tc * N * N + 2 * Tc * (Tc + 1) * N
    return _roofline(nbytes, ops * B * H, "float32")


def rwkv_path(dev) -> dict:
    """The RWKV6 serving path: ``wkv`` against its plain version at
    rwkv6-7b's prefill shapes (and timed there), ``ServingEngine`` at
    rwkv6-7b's full width and depth with the launch counts set to 0 just
    before and read just after, decode-vs-forward over a ragged last
    chunk, and card == CPU on a reduced float32 engine.  Returns the wkv
    report entry."""
    import torch

    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.rwkv6 import wkv_chunked_ref, wkv_fwd
    from repro_torch.models import rwkv
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import init_cache
    from repro_torch.serve import engine as E
    from repro_torch.serve import kv_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    print(f"[serve-rwkv] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated on entry (the MoE phase's weights freed)")
    cfg = get_config(RWKV_ARCH)
    H, N = rwkv._dims(cfg)
    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # -- [kernel] / [time] wkv at rwkv6-7b's prefill shapes -----------------
    # inputs as tests/test_kernels.py makes them (k x 0.3, u x 0.1); log
    # decays from the model's init range (-exp(U[-8, -4])) and from that
    # test's [-1, -0.01]; zero and carried state; a ragged S
    def logw_of(kind, S):
        u01 = torch.rand(1, S, H, N, generator=gen, device=dev)
        if kind == "init":
            return -torch.exp(u01 * 4.0 - 8.0)
        return -(0.01 + 0.99 * u01)

    def check(what, dtype, args, chunk):
        y, s_T = wkv_fwd(*args, chunk=chunk)
        torch.cuda.synchronize()
        ry, rs = wkv_chunked_ref(*args, chunk=chunk)
        worst, errs = 0.0, {}
        for name, out, ref, tol in (("y", y, ry, WKV_TOLS[dtype]),
                                    ("s_T", s_T, rs, WKV_TOLS["float32"])):
            ref = ref.float()
            d = (out.float() - ref).abs()
            errs[name] = d.max().item()
            ratio = (d / (tol[0] + tol[1] * ref.abs())).max().item()
            worst = max(worst, ratio)
            print(f"[kernel] wkv {what}: {name} max abs err "
                  f"{errs[name]:.3g}; limit {tol[0]:g} + {tol[1]:g} "
                  f"|ref|, largest err/limit {ratio:.3g}; mean |ref| "
                  f"{ref.abs().mean().item():.3g}")
        if not (worst <= 1.0 and torch.isfinite(y).all()
                and torch.isfinite(s_T).all()):
            fail(f"wkv {what} differs from its plain version: "
                 f"{errs}, largest err/limit {worst}")
        return dict(what=what, dtype=dtype, err=max(errs.values()),
                    err_over_limit=worst)

    cases = []
    for S, kind, carried in ((WKV_S, "init", False), (WKV_S, "init", True),
                             (WKV_S, "fast", True), (WKV_S - 1, "init", True)):
        r, k, v = randn(1, S, H, N), randn(1, S, H, N, scale=0.3), randn(
            1, S, H, N)
        logw, u = logw_of(kind, S), randn(H, N, scale=0.1)
        s0 = randn(1, H, N, N, scale=0.5) if carried else None
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            rr, kk, vv = (a.to(dt) for a in (r, k, v))
            decays = ("in the init range" if kind == "init"
                      else "in [-1, -0.01]")
            what = (f"B=1 S={S} H={H} N={N} chunk={WKV_CHUNK} {dtype} r/k/v, "
                    f"logw {decays}, s0 {'carried' if carried else 'zero'}")
            case = check(what, dtype, (rr, kk, vv, logw, u, s0), WKV_CHUNK)
            if S == WKV_S and kind == "init" and carried:
                ms = cuda_ms(lambda: wkv_fwd(rr, kk, vv, logw, u, s0,
                                             chunk=WKV_CHUNK), 20)
                plain_ms = cuda_ms(lambda: wkv_chunked_ref(
                    rr, kk, vv, logw, u, s0, chunk=WKV_CHUNK), 3)
                b_ms, b_by = wkv_bound(1, S, H, N, WKV_CHUNK, dtype)
                print(f"[time] wkv {what}: {ms:.4f} ms per launch, plain "
                      f"version {plain_ms:.4f} ms, no PyTorch call computes "
                      f"the recurrence, bound {b_ms:.5f} ms ({b_by}), "
                      f"{b_ms / ms:.3f} of it reached")
                case.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by)
            cases.append(case)
    torch.cuda.empty_cache()
    for B, S, Hs, Ns, ch in WKV_EDGE:
        r, k, v = randn(B, S, Hs, Ns), randn(B, S, Hs, Ns, scale=0.3), randn(
            B, S, Hs, Ns)
        logw = -(0.01 + 0.99 * torch.rand(B, S, Hs, Ns, generator=gen,
                                          device=dev))
        u, s0 = randn(Hs, Ns, scale=0.1), randn(B, Hs, Ns, Ns, scale=0.5)
        for dtype in ("bfloat16", "float32"):
            rr, kk, vv = (a.to(getattr(torch, dtype)) for a in (r, k, v))
            for st in (None, s0):
                what = (f"edge B={B} S={S} H={Hs} N={Ns} chunk={ch} {dtype} "
                        f"r/k/v, logw in [-1, -0.01], s0 "
                        f"{'zero' if st is None else 'carried'}")
                cases.append(check(what, dtype, (rr, kk, vv, logw, u, st),
                                   ch))

    # -- [serve-rwkv] ServingEngine at rwkv6-7b's full width and depth ------
    chips = kv_cache.chips_needed(cfg, 1, 8192)
    rwkv_classes = (SERVE_CLASSES[0], ("big", RWKV_ARCH, 8192, chips, 4.0,
                                       0.2))
    classes = [E.RequestClass(n, get_config(a), b, c, s, al)
               for n, a, b, c, s, al in rwkv_classes]
    print(f"[serve-rwkv] {RWKV_ARCH} needs {chips} chips at bucket 8192 "
          f"(state cache {kv_cache.cache_bytes(cfg, 1, 8192) / 1e6:.1f} MB)")
    eng, runs, rng_s = admitted_big_runs(classes, "serve-rwkv", dev)
    model = eng._model("big")
    cfg = model.cfg
    t0 = time.time()
    params = eng._get_params("big")            # weights on the card: set-up
    torch.cuda.synchronize()
    f32 = sum(t.numel() for t in tree_leaves(params)
              if t.dtype == torch.float32)
    print(f"[serve-rwkv] {RWKV_ARCH} weights made on the card in "
          f"{time.time() - t0:.1f} s: {cfg.num_params() / 1e9:.2f} B params "
          f"({f32 / 1e6:.1f} M kept in float32, the leaves read in "
          f"float32), {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    L = cfg.num_layers
    wkv_fwd.launches = gmm.launches = flash_attention_fwd.launches = 0
    decode_attention_fwd.launches = 0
    t0 = time.time()
    walls = {}
    for S, jid in sorted(runs.items()):
        before = wkv_fwd.launches
        req = eng.run_request(jid)
        torch.cuda.synchronize()
        if len(req.output) != SERVE_NEW or not all(
                0 <= t < cfg.vocab_size for t in req.output):
            fail(f"rwkv request {req.rid} (prompt {S}) gave tokens "
                 f"{req.output}")
        walls[S] = (req.prefill_s, req.decode_s / (SERVE_NEW - 1))
        print(f"[serve-rwkv] request {req.rid} prompt {S}: prefill "
              f"{req.prefill_s * 1e3:.1f} ms to the first token, decode "
              f"{walls[S][1] * 1e3:.2f} ms per token; "
              f"{wkv_fwd.launches - before} wkv launches; first tokens "
              f"{req.output[:8]}")
    counts = {"wkv": wkv_fwd.launches, "gmm": gmm.launches,
              "flash_attention": flash_attention_fwd.launches,
              "decode_attention": decode_attention_fwd.launches}
    n = len(runs)
    want = {"wkv": L * n, "gmm": 0, "flash_attention": 0,
            "decode_attention": 0}
    print(f"[serve-rwkv] {n} rwkv requests end to end in "
          f"{time.time() - t0:.1f} s; launches {counts} (expected {want}: "
          f"wkv L per prefill and none per decoded token)")
    if counts != want:
        fail(f"rwkv launch counts {counts} differ from {want}")
    for jid in runs.values():
        eng.complete(jid, 1.0)

    # decode-vs-forward at full width; prefill(511) ends in a ragged chunk
    toks = torch.tensor(rng_s.integers(1, cfg.vocab_size, SERVE_PROMPTS[0]),
                        device=dev)
    S = SERVE_PROMPTS[0] - 1
    full, _ = model.prefill(params, {"tokens": toks[None, :S + 1]})
    _, pre = model.prefill(params, {"tokens": toks[None, :S]})
    caches = E._seed_caches(init_cache(cfg, 1, S + 8, device=dev), pre, S)
    step, _ = model.decode_step(params, caches, toks[None, S:S + 1], S)
    if not (torch.isfinite(full).all() and torch.isfinite(step).all()):
        fail(f"{RWKV_ARCH}: non-finite logits")
    diff = (full.float() - step.float()).abs().max().item()
    print(f"[serve-rwkv] {RWKV_ARCH} decode-vs-forward: prefill({S}, last "
          f"chunk {S % WKV_CHUNK} steps) + decode vs prefill({S + 1}) last "
          f"logits max abs diff {diff:.4f} (bound 0.25); largest logit "
          f"{full.float().abs().max().item():.3f}")
    if not diff < 0.25:
        fail(f"{RWKV_ARCH} decode-vs-forward diff {diff} >= 0.25")
    # teacher-forced, layer by layer: the recurrent state after prefill(S)
    # in place of the cache, each layer fed prefill(S + 1)'s input there
    rel = dvf.layer_by_layer(model, params, toks, S)
    worst_l = max(range(len(rel)), key=rel.__getitem__)
    print(f"[serve-rwkv] {RWKV_ARCH} decode-vs-forward, layer by layer: "
          f"decode at token {S} after prefill({S}) (the recurrent state in "
          f"place of the cache), each layer fed prefill({S + 1})'s input "
          f"there, against prefill({S + 1})'s output: largest |diff| / max "
          f"|row| {rel[worst_l]:.5f} (layer {worst_l} of {len(rel)}; bound "
          f"{dvf.LAYER_TOL:g}); free running {diff:.4f} (bound 0.25)")
    if len(rel) != cfg.num_layers or not rel[worst_l] <= dvf.LAYER_TOL:
        fail(f"{RWKV_ARCH} decode-vs-forward layer {worst_l}: "
             f"{rel[worst_l]} > {dvf.LAYER_TOL}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve-rwkv] peak memory in the phase {peak:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")
    del eng, params, model, caches, pre, full, step
    torch.cuda.empty_cache()

    # card == CPU: a reduced float32 engine with the same weights; rwkv
    # prompts of 100 end in a ragged chunk (attention's must divide its
    # chunk of 64)
    card_equals_cpu([E.RequestClass(n, dataclasses.replace(
        get_config(a), compute_dtype="float32").reduced(), b, c, s, al)
        for n, a, b, c, s, al in rwkv_classes], "serve-rwkv", (64, 100),
        wkv_fwd, dev)

    top = next(c for c in cases if "ms" in c and c["dtype"] == "bfloat16")
    f32_case = next(c for c in cases if "ms" in c and c["dtype"] == "float32")
    return {"wkv": dict(
        name="wkv", route="cuda", source=WKV[0], replaces=WKV[1],
        launches=counts["wkv"], max_abs_err=max(c["err"] for c in cases),
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None, shape=top["what"],
        float32=dict(ms=f32_case["ms"], plain_ms=f32_case["plain_ms"],
                     bound_ms=f32_case["bound_ms"]),
        configs=cases,
        rwkv_launches={k: v for k, v in counts.items() if k != "wkv"},
        peak_gb=peak, decode_vs_forward=dict(
            free_running=diff, layer_by_layer=rel[worst_l]),
        serve_s={f"prompt {S}": {"prefill": p, "decode_per_token": d}
                 for S, (p, d) in sorted(walls.items())})}


def mamba_bound(B, S, d_in, N, *, fused, dtype, carried=True):
    """Least time for one selective-scan call.  Fused entry: dt read in
    float32 and u in its dtype, A, Bm, C (and h0 when carried) once, y and
    h_T written in float32; per (t, d, n) one exponential and 7 float32
    operations (dt A, dt Bm, x u, a h + b, h C + y).  Reference entry: a and
    b read in their dtype and c once, y written in a's dtype; 4 float32
    operations per (t, d, n).  Operations at the float32 CUDA-core peak
    (an exponential counted as one operation)."""
    item = 2 if dtype == "bfloat16" else 4
    steps = B * S * d_in * N
    if fused:
        nbytes = (4 * B * S * d_in + item * B * S * d_in + 4 * d_in * N
                  + 2 * 4 * B * S * N + 4 * B * S * d_in
                  + 4 * B * d_in * N * (2 if carried else 1))
        ops = 8 * steps
    else:
        nbytes = 2 * item * steps + 4 * B * S * N + item * B * S * d_in
        ops = 4 * steps
    return _roofline(nbytes, ops, "float32")


def hybrid_path(dev) -> dict:
    """The hybrid serving path: ``mamba_scan`` (both entries) against its
    plain versions at jamba-1.5-large's layer shape (and timed there),
    ``gmm`` at the cut's expert shapes, ``ServingEngine`` on the cut
    (``hybrid_cut``) with the launch counts set to 0 just before and read
    just after, decode-vs-forward with the drop counts, and card == CPU on
    a reduced float32 engine.  Returns (the mamba_scan report entry, the
    gmm cases at the cut's shapes)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba_scan import (mamba_scan_fused,
                                                mamba_scan_fused_ref,
                                                mamba_scan_fwd,
                                                mamba_scan_ref)
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.rwkv6 import wkv_fwd
    from repro_torch.models import mamba, moe
    from repro_torch.models.layers import PDef, init_params, tree_leaves
    from repro_torch.models.model import init_cache
    from repro_torch.models.transformer import decoder_stages
    from repro_torch.serve import engine as E
    from repro_torch.serve import kv_cache
    from repro_torch.serve.cuts import hybrid_cut

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    print(f"[serve-hybrid] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated on entry (the RWKV phase's weights freed)")
    full = get_config(HYBRID_ARCH)
    cut = hybrid_cut(full)
    d_in, N, _, _ = mamba._dims(cut)
    gen = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def check(name, what, out, ref, bf16=False):
        ref = ref.float()
        d = (out.float() - ref).abs()
        limit = MAMBA_TOLS[0] + MAMBA_TOLS[1] * ref.abs()
        if bf16:   # two bfloat16 units in the last place of |ref|
            limit = limit + 2 * torch.exp2(torch.floor(torch.log2(
                ref.abs().clamp_min(1e-30))) - 7)
        err, ratio = d.max().item(), (d / limit).max().item()
        print(f"[kernel] {name} {what}: max abs err {err:.3g}; limit "
              f"{MAMBA_TOLS[0]:g} + {MAMBA_TOLS[1]:g} |ref|"
              f"{' + 2 bf16 units' if bf16 else ''}, largest err/limit "
              f"{ratio:.3g}; mean |ref| {ref.abs().mean().item():.3g}")
        if not (ratio <= 1.0 and torch.isfinite(out).all()):
            fail(f"{name} {what} differs from its plain version: max abs "
                 f"err {err}, largest err/limit {ratio}")
        return err, ratio

    # -- [kernel] / [time] mamba_scan at jamba's layer (B 1, S 2048) --------
    # decays from the model's init (dt = softplus of a mamba_dt draw, A =
    # -exp(mamba_A) = -(1..16)) and from tests/test_kernels.py's a in
    # [0.5, 0.99] (A = -1, dt = -log a); zero and carried state; S = 2047
    A_init = -torch.exp(init_params(PDef((d_in, N), (None, None), "mamba_A"),
                                    gen))
    A_fast = -torch.ones(d_in, N, device=dev)

    def decays(kind, S):
        if kind == "init":
            bias = init_params(PDef((1, S, d_in), (None,) * 3, "mamba_dt"),
                               gen)
            return F.softplus(bias), A_init
        a = torch.rand(1, S, d_in, generator=gen, device=dev) * 0.49 + 0.5
        return -torch.log(a), A_fast

    cases, timed = [], {}
    for S, kind, carried, dtype in (
            (MAMBA_S, "init", False, "bfloat16"),
            (MAMBA_S, "init", True, "bfloat16"),
            (MAMBA_S, "init", True, "float32"),
            (MAMBA_S, "fast", True, "bfloat16"),
            (MAMBA_S - 1, "init", True, "bfloat16"),
            (MAMBA_S - 1, "fast", False, "float32")):
        dt, A = decays(kind, S)
        Bm, C = randn(1, S, N), randn(1, S, N)
        u = randn(1, S, d_in).to(getattr(torch, dtype))
        h0 = randn(1, d_in, N, scale=0.5) if carried else None
        src = "from the init" if kind == "init" else "with a in [0.5, 0.99]"
        what = (f"fused B=1 S={S} d_in={d_in} N={N} u {dtype}, dt / A "
                f"{src}, h0 {'carried' if carried else 'zero'}")
        y, h_T = mamba_scan_fused(dt, A, Bm, u, C, h0)
        torch.cuda.synchronize()
        ry, rh = mamba_scan_fused_ref(dt, A, Bm, u, C, h0)
        ey, qy = check("mamba_scan", what + ": y", y, ry)
        eh, qh = check("mamba_scan", what + ": h_T", h_T, rh)
        case = dict(entry="fused", what=what, dtype=dtype, err=max(ey, eh),
                    err_over_limit=max(qy, qh))
        if S == MAMBA_S and kind == "init" and carried:
            ms = cuda_ms(lambda: mamba_scan_fused(dt, A, Bm, u, C, h0), 20)
            plain_ms = cuda_ms(lambda: mamba_scan_fused_ref(
                dt, A, Bm, u, C, h0), 2)
            b_ms, b_by = mamba_bound(1, S, d_in, N, fused=True, dtype=dtype)
            print(f"[time] mamba_scan {what}: {ms:.4f} ms per launch, plain "
                  f"version {plain_ms:.4f} ms, no PyTorch call computes the "
                  f"scan, bound {b_ms:.5f} ms ({b_by}), {b_ms / ms:.3f} of it "
                  f"reached")
            case.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by)
            timed[("fused", dtype)] = case
        cases.append(case)
        if kind == "init" and S == MAMBA_S and not carried:
            # the reference entry on the same decays, discretised here
            init_abc = (torch.exp(dt[..., None] * A),
                        (dt[..., None] * Bm[:, :, None, :])
                        * u.float()[..., None], C)
        del y, h_T, ry, rh
    torch.cuda.empty_cache()
    for B, S, de, Ne in MAMBA_EDGE:
        a = torch.rand(B, S, de, generator=gen, device=dev) * 0.49 + 0.5
        dt, A = -torch.log(a), -torch.ones(de, Ne, device=dev)
        Bm, C, h0 = randn(B, S, Ne), randn(B, S, Ne), randn(B, de, Ne,
                                                               scale=0.5)
        for dtype in ("bfloat16", "float32"):
            u = randn(B, S, de).to(getattr(torch, dtype))
            for st in (None, h0):
                what = (f"fused edge B={B} S={S} d_in={de} N={Ne} u {dtype}, "
                        f"a in [0.5, 0.99], h0 "
                        f"{'zero' if st is None else 'carried'}")
                y, h_T = mamba_scan_fused(dt, A, Bm, u, C, st)
                torch.cuda.synchronize()
                ry, rh = mamba_scan_fused_ref(dt, A, Bm, u, C, st)
                ey, qy = check("mamba_scan", what + ": y", y, ry)
                eh, qh = check("mamba_scan", what + ": h_T", h_T, rh)
                cases.append(dict(entry="fused", what=what, dtype=dtype,
                                  err=max(ey, eh),
                                  err_over_limit=max(qy, qh)))

    for kind in ("init", "fast"):
        S = MAMBA_S
        if kind == "init":
            a, b, c = init_abc
            del init_abc
        else:   # tests/test_kernels.py's inputs
            a = torch.rand(1, S, d_in, N, generator=gen, device=dev) * 0.49 \
                + 0.5
            b = randn(1, S, d_in, N, scale=0.2)
            c = randn(1, S, N)
        for dtype in ("float32", "bfloat16"):
            aa, bb = (x.to(getattr(torch, dtype)) for x in (a, b))
            src = "from the init" if kind == "init" else "in [0.5, 0.99]"
            what = (f"reference entry B=1 S={S} d_in={d_in} N={N} a/b "
                    f"{dtype}, a {src}")
            y = mamba_scan_fwd(aa, bb, c, chunk=128)
            torch.cuda.synchronize()
            err, q = check("mamba_scan", what, y, mamba_scan_ref(aa, bb, c),
                           bf16=dtype == "bfloat16")
            case = dict(entry="reference", what=what, dtype=dtype, err=err,
                        err_over_limit=q)
            if kind == "init":
                ms = cuda_ms(lambda: mamba_scan_fwd(aa, bb, c, chunk=128), 10)
                plain_ms = cuda_ms(lambda: mamba_scan_ref(aa, bb, c), 2)
                b_ms, b_by = mamba_bound(1, S, d_in, N, fused=False,
                                         dtype=dtype)
                print(f"[time] mamba_scan {what}: {ms:.4f} ms per launch, "
                      f"plain version {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                      f"({b_by}), {b_ms / ms:.3f} of it reached")
                case.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by)
                timed[("reference", dtype)] = case
            cases.append(case)
            del aa, bb, y
        del a, b
    torch.cuda.empty_cache()

    # -- [kernel] / [time] gmm at the cut's expert shapes -------------------
    # 8 held experts of K 8192 x N 24576 (gate/up) and 24576 x 8192 (down):
    # a 2048-token prefill (C = 320, block_m 128) with a skewed fill, and
    # one decoded token (C = 2, block_m 16, two rows in one expert); the
    # plain version runs one expert at a time (its float32 weight gather
    # of a whole [8, 8192, 24576] stack would take 6.4 GB per block)
    m = cut.moe
    H = moe.experts_held(m)
    rng = np.random.default_rng(19)
    gmm_cases = []
    for phase, T in (("prefill", MAMBA_S), ("decode", 1)):
        C = moe._capacity(m, T)
        bm = moe.block_m_for(C)
        Cp = (C + bm - 1) // bm * bm
        if T > 1:
            fill = rng.multinomial(T * m.top_k // 2, rng.dirichlet(
                np.full(H, 2.0)))
            fill[0] = 0                            # one expert gets nothing
        else:
            fill = np.zeros(H, np.int64)
            fill[3] = m.top_k
        fill = np.minimum(fill, C)
        be, nv = moe._fill_blocks(torch.tensor(fill, device=dev), C, bm)
        valid = (nv > 0).cpu().numpy()
        rows = int(valid.sum()) * bm
        experts = int((fill > 0).sum())
        for proj, Kd, Nd in (("gate/up", cut.d_model, m.d_ff_expert),
                             ("down", m.d_ff_expert, cut.d_model)):
            x = randn(H * Cp, Kd).to(torch.bfloat16)
            w = torch.empty(H, Kd, Nd, dtype=torch.bfloat16, device=dev)
            for e in range(H):
                w[e] = randn(Kd, Nd, scale=1 / math.sqrt(Kd))
            out = gmm(x, w, be, nv, block_m=bm)
            torch.cuda.synchronize()
            route = gmm.last_route
            what = (f"jamba cut {phase} {proj} held {H} of "
                    f"{m.num_experts} experts, C={C} Cp={Cp} block_m={bm} "
                    f"K={Kd} N={Nd} bfloat16: {int(valid.sum())} of "
                    f"{len(valid)} blocks valid, {route} kernel")
            if route != gmm_want_route("bfloat16", bm):
                fail(f"gmm {what}: took the {route} kernel, not "
                     f"{gmm_want_route('bfloat16', bm)}")
            atol, rtol = ATTN_TOLS["bfloat16"]
            worst, err, zeros = gmm_vs_plain(out, x, w, be, nv, bm)
            print(f"[kernel] gmm {what}: max abs err {err:.3g}; limit "
                  f"{atol:g} + {rtol:g} |ref| per element (plain version "
                  f"one expert at a time), largest err/limit {worst:.3g}; "
                  f"skipped blocks exactly zero: {zeros}")
            if not (worst <= 1.0 and zeros):
                fail(f"gmm {what} differs from its plain version: max abs "
                     f"err {err}, largest err/limit {worst}, skipped blocks "
                     f"zero {zeros}")
            ms = cuda_ms(lambda: gmm(x, w, be, nv, block_m=bm), 3)
            xb = x.view(H, Cp, Kd)
            lib_ms = cuda_ms(lambda: torch.bmm(xb, w), 3)
            b_ms, b_by = gmm_bound(rows, experts, x.shape[0], Kd, Nd,
                                   len(valid), "bfloat16")
            case = dict(what=what, dtype="bfloat16", kernel_route=route,
                        err=err, err_over_limit=worst, ms=ms,
                        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            simt = ""
            if route != "simt":            # the CUDA-core kernel it replaced
                case["simt_ms"] = cuda_ms(lambda: gmm_kernel._launch(
                    x, w, be, nv, bm, "simt"), 2)
                simt = (f", the simt kernel on the same call "
                        f"{case['simt_ms']:.4f} ms")
            print(f"[time] gmm {what}: {ms:.4f} ms per launch ({b_ms / ms:.3f} "
                  f"of the {b_by} bound), torch.bmm over the [H, Cp, K] "
                  f"buffer {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
                  f"{simt}")
            gmm_cases.append(case)
            del x, w, out, xb
    torch.cuda.empty_cache()

    # -- [serve-hybrid] ServingEngine on the cut ----------------------------
    chips = kv_cache.chips_needed(cut, 1, 8192)
    classes = [E.RequestClass(SERVE_CLASSES[0][0],
                              get_config(SERVE_CLASSES[0][1]),
                              *SERVE_CLASSES[0][2:]),
               E.RequestClass("big", cut, 8192, chips, 4.0, 0.2)]
    print(f"[serve-hybrid] {cut.name}: {full.name} cut to one block of "
          f"{cut.num_layers} layers at full width, {H} of "
          f"{m.num_experts} experts held; needs {chips} chips at bucket 8192 "
          f"(cache {kv_cache.cache_bytes(cut, 1, 8192) / 1e6:.1f} MB); the "
          f"uncut model {full.num_params() / 1e9:.1f} B params")
    eng, runs, rng_s = admitted_big_runs(classes, "serve-hybrid", dev)
    model = eng._model("big")
    cfg = model.cfg
    t0 = time.time()
    params = eng._get_params("big")            # weights on the card: set-up
    torch.cuda.synchronize()
    f32 = sum(t.numel() for t in tree_leaves(params)
              if t.dtype == torch.float32)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve-hybrid] weights made on the card in {time.time() - t0:.1f}"
          f" s: {cfg.num_params() / 1e9:.2f} B params ({f32 / 1e6:.1f} M "
          f"kept in float32, the leaves read in float32; "
          f"{cfg.active_params() / 1e9:.2f} B active per token on this "
          f"card), {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{init_peak:.2f} GB peak while drawing them")
    torch.cuda.reset_peak_memory_stats()
    specs = [s for st in decoder_stages(cfg) for s in st.pattern
             for _ in range(st.repeats)]
    n_moe = sum(s.ffn == "moe" for s in specs)
    n_mamba = sum(s.kind == "mamba" for s in specs)
    n_attn = sum(s.kind == "attn" for s in specs)

    # dropped and absent (token, slot) pairs: each prefill's MoE layer
    # inputs are kept and routed again after the pass.  One token never
    # drops (C >= top-k); pairs routed to the experts held elsewhere add
    # nothing in every pass alike
    if moe._capacity(m, 1) < m.top_k:
        fail(f"decode capacity {moe._capacity(m, 1)} < top-k {m.top_k}")
    with KeptMoEInputs(moe, m) as kept:
        mamba_scan_fused.launches = mamba_scan_fwd.launches = 0
        gmm.launches = wkv_fwd.launches = flash_attention_fwd.launches = 0
        decode_attention_fwd.launches = 0
        t0 = time.time()
        walls = {}
        for S, jid in sorted(runs.items()):
            before = mamba_scan_fused.launches
            req = eng.run_request(jid)
            torch.cuda.synchronize()
            dropped, _, absent = kept.drops(H)
            if len(req.output) != SERVE_NEW or not all(
                    0 <= t < cfg.vocab_size for t in req.output):
                fail(f"jamba request {req.rid} (prompt {S}) gave tokens "
                     f"{req.output}")
            walls[S] = (req.prefill_s, req.decode_s / (SERVE_NEW - 1))
            print(f"[serve-hybrid] request {req.rid} prompt {S}: prefill "
                  f"{req.prefill_s * 1e3:.1f} ms to the first token, decode "
                  f"{walls[S][1] * 1e3:.2f} ms per token; "
                  f"{mamba_scan_fused.launches - before} mamba_scan "
                  f"launches; {dropped} of {S * m.top_k * n_moe} (token, "
                  f"slot) pairs dropped in prefill (C = "
                  f"{moe._capacity(m, S)}), {absent} routed to the experts "
                  f"held elsewhere; first tokens {req.output[:8]}")
        counts = {"mamba_scan": mamba_scan_fused.launches,
                  "mamba_scan_reference_entry": mamba_scan_fwd.launches,
                  "gmm": gmm.launches,
                  "flash_attention": flash_attention_fwd.launches,
                  "decode_attention": decode_attention_fwd.launches,
                  "wkv": wkv_fwd.launches}
        n = len(runs)
        want = {"mamba_scan": n_mamba * n, "mamba_scan_reference_entry": 0,
                "gmm": 3 * n_moe * n * SERVE_NEW,
                "flash_attention": n_attn * n,
                "decode_attention": n_attn * n * (SERVE_NEW - 1), "wkv": 0}
        print(f"[serve-hybrid] {n} jamba requests end to end in "
              f"{time.time() - t0:.1f} s; launches {counts} (expected "
              f"{want}: mamba_scan {n_mamba} per prefill and none per "
              f"token, gmm 3 x {n_moe} per prefill and per token after the "
              f"first, flash {n_attn} per prefill, decode {n_attn} per "
              f"token after the first)")
        if counts != want:
            fail(f"hybrid launch counts {counts} differ from {want}")
        for jid in runs.values():
            eng.complete(jid, 1.0)

        # decode-vs-forward at full width, with the pairs each pass dropped
        toks = torch.tensor(rng_s.integers(1, cfg.vocab_size,
                                           SERVE_PROMPTS[0]), device=dev)
        S = SERVE_PROMPTS[0] - 1
        drops = {}
        full_logits, _ = model.prefill(params,
                                       {"tokens": toks[None, :S + 1]})
        drops[S + 1], last, _ = kept.drops(H)
        _, pre = model.prefill(params, {"tokens": toks[None, :S]})
        drops[S] = kept.drops(H)[0]
    caches = E._seed_caches(init_cache(cfg, 1, S + 8, device=dev), pre, S)
    step, _ = model.decode_step(params, caches, toks[None, S:S + 1], S)
    if not (torch.isfinite(full_logits).all()
            and torch.isfinite(step).all()):
        fail(f"{cut.name}: non-finite logits")
    diff = (full_logits.float() - step.float()).abs().max().item()
    print(f"[serve-hybrid] {cut.name} decode-vs-forward: prefill({S}) + "
          f"decode vs prefill({S + 1}) last logits max abs diff {diff:.4f}; "
          f"largest logit {full_logits.float().abs().max().item():.3f}; "
          f"pairs dropped: prefill({S}) {drops[S]}, prefill({S + 1}) "
          f"{drops[S + 1]} (its last token {last}), decode 0 (C = "
          f"{moe._capacity(m, 1)} >= top-k)")
    if drops[S] == drops[S + 1] == 0:
        print("[serve-hybrid] no pass dropped a pair: held to 0.25")
        if not diff < 0.25:
            fail(f"{cut.name} decode-vs-forward diff {diff} >= 0.25")
    else:
        print(f"[serve-hybrid] not held to 0.25: at capacity factor "
              f"{m.capacity_factor} a {S + 1}-token prefill has C = "
              f"{moe._capacity(m, S + 1)} rows per expert and drops pairs "
              f"that decode keeps, so the two passes compute different "
              f"functions, on the reference too")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve-hybrid] peak memory while serving {peak:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
          f"({init_peak:.2f} GB while drawing the weights)")
    del eng, params, model, caches, pre, full_logits, step
    torch.cuda.empty_cache()

    # card == CPU: a reduced float32 engine with the same weights (the
    # reduced cut holds 4 of its 8 experts); jamba prompts of 40 end in a
    # ragged scan chunk (chunk 16)
    card_equals_cpu([E.RequestClass(SERVE_CLASSES[0][0], dataclasses.replace(
        get_config(SERVE_CLASSES[0][1]), compute_dtype="float32").reduced(),
        *SERVE_CLASSES[0][2:]),
        E.RequestClass("big", dataclasses.replace(
            cut, compute_dtype="float32").reduced(), 8192, chips, 4.0, 0.2)],
        "serve-hybrid", (64, 40), mamba_scan_fused, dev)

    top = timed[("fused", "bfloat16")]
    return dict(
        name="mamba_scan", route="cuda", source=MAMBA[0], replaces=MAMBA[1],
        launches=counts["mamba_scan"],
        max_abs_err=max(c["err"] for c in cases), ms=top["ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None,
        shape=top["what"] + " (mamba_scan_fused, the model's entry)",
        float32={k: timed[("fused", "float32")][k]
                 for k in ("ms", "plain_ms", "bound_ms")},
        reference_entry={dt: {k: timed[("reference", dt)][k]
                              for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")}
                         for dt in ("float32", "bfloat16")},
        configs=cases,
        hybrid_launches={k: v for k, v in counts.items()
                         if k != "mamba_scan"},
        peak_gb=peak, weights_init_peak_gb=init_peak,
        serve_s={f"prompt {S}": {"prefill": p, "decode_per_token": d}
                 for S, (p, d) in sorted(walls.items())}), gmm_cases


@contextlib.contextmanager
def keep_decode_calls(checked: dict):
    """While active (``with``), each decode_attention call of the model
    code is held at once to its plain version on the same inputs (the
    caches change at the next step); ``checked`` maps the call's shape
    (B, Sk, H, Kh, D, Dv, pos) to [calls, largest err/limit at the bf16
    limit, largest err/limit with its atol at the data's scale, largest
    abs err, (q, k, v, pos) copies of its first call].

    The bf16 limit's atol, 1e-5, is the float32 sums' own difference for
    values of order one.  The served layers' v reach |v| ~ 26 at this
    init, and their near-argmax attention gives outputs near zero from
    cancelling terms of that size, where the kernel's and the plain
    version's float32 sums (split and combined on the card, one einsum in
    the plain version) differ by ~2e-6 of the terms: 4.8e-5 on an output
    of 2.3e-4 (seamless cross decode, Sk 2560; both that far from the
    float64 value).  So the served calls are also held with the atol at
    the data's scale, 1e-5 max |v|; random inputs of order one at the
    same shapes are held at the bf16 limit itself (``xattn_path``)."""
    from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                      decode_attention_ref)
    from repro_torch.models import layers

    def keeping(q, k, v, pos):
        out = decode_attention_fwd(q, k, v, pos)
        key = (q.shape[0], k.shape[1], q.shape[1], k.shape[2], q.shape[2],
               v.shape[3], tuple(pos.tolist()))
        ref = decode_attention_ref(q, k, v, pos).float()
        if key not in checked:
            checked[key] = [0, 0.0, 0.0, 0.0, (q.clone(), k.clone(),
                                               v.clone(), pos.clone())]
        c = checked[key]
        d = (out.float() - ref).abs()
        atol, rtol = ATTN_TOLS["bfloat16"]
        scale = max(1.0, v.float().abs().max().item())
        c[0] += 1
        c[1] = max(c[1], (d / (atol + rtol * ref.abs())).max().item())
        c[2] = max(c[2], (d / (atol * scale + rtol * ref.abs())).max()
                   .item())
        c[3] = max(c[3], d.max().item())
        return out

    layers.decode_attention_fwd = keeping
    try:
        yield checked
    finally:
        layers.decode_attention_fwd = decode_attention_fwd


def attention_checks(tag: str, name: str, flash_kept: list,
                     decode_checked: dict) -> tuple:
    """Hold each kept flash call (``dvf.keep_flash_calls``) to its plain
    version at the bf16 limit, grouped by shape, each on the route
    ``_flash_route`` gives bf16, and print them and the decode shapes
    ``keep_decode_calls`` held.  Returns (flash cases, decode cases), one
    per shape, with the first call's inputs for timing."""
    import torch

    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import _flash_route

    shapes = {}
    for q, k, v, out, route, causal in flash_kept:
        B, Sq, H, D = q.shape
        _, Sk, Kh, Dv = v.shape
        key = (B, Sq, Sk, H, Kh, D, Dv, causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        c = shapes.setdefault(key, dict(calls=0, worst=0.0, err=0.0,
                                        routes=set(), args=(q, k, v)))
        c["calls"] += 1
        c["worst"] = max(c["worst"], dvf.err_over_limit(out, ref))
        c["err"] = max(c["err"], (out.float() - ref.float()).abs().max()
                       .item())
        c["routes"].add(route)
        del ref
    flash_cases = []
    for key, c in shapes.items():
        B, Sq, Sk, H, Kh, D, Dv, causal = key
        route = _flash_route(torch.bfloat16, D, Dv)
        what = (f"{name} B={B} Sq={Sq} Sk={Sk} H={H} Kh={Kh} D={D} Dv={Dv} "
                f"bfloat16 {'causal' if causal else 'non-causal'}, "
                f"{'/'.join(sorted(map(str, c['routes'])))} kernel")
        print(f"[kernel] flash_attention {what}: {c['calls']} calls of the "
              f"served prefills on the model's own q, k, v against the "
              f"plain version: largest err/limit {c['worst']:.3g} (limit "
              f"{ATTN_TOLS['bfloat16'][0]:g} + {ATTN_TOLS['bfloat16'][1]:g}"
              f" |ref|)")
        if c["routes"] != {route}:
            fail(f"[{tag}] flash_attention {what}: expected the {route} "
                 f"kernel")
        if not c["worst"] <= 1.0:
            fail(f"[{tag}] flash_attention {what} differs from its plain "
                 f"version: err/limit {c['worst']}")
        flash_cases.append(dict(what=what, shape=key, err=c["err"],
                                err_over_limit=c["worst"],
                                kernel_route=route,
                                args=c["args"]))
    decode_cases = []
    for key, (calls, unit, scaled, err, args) in decode_checked.items():
        B, Sk, H, Kh, D, Dv, pos = key
        what = (f"{name} B={B} Sk={Sk} H={H} Kh={Kh} (G={H // Kh}) D={D} "
                f"bfloat16 pos={list(pos)}")
        print(f"[kernel] decode_attention {what}: {calls} calls of the "
              f"served decode steps against the plain version on the same "
              f"inputs: largest err/limit {scaled:.3g} with the atol at the "
              f"data's scale (1e-5 max |v| + 2^-6 |ref|; "
              f"{unit:.3g} at 1e-5 + 2^-6 |ref|); max abs err {err:.3g}")
        if not scaled <= 1.0:
            fail(f"[{tag}] decode_attention {what} differs from its plain "
                 f"version: err/limit {scaled}")
        decode_cases.append(dict(what=what, err=err, err_over_limit=scaled,
                                 err_over_unit_limit=unit, args=args))
    return flash_cases, decode_cases


def time_attention(flash_cases, decode_cases) -> None:
    """``[time]`` lines of the flash and decode cases at their kept
    inputs: the kernel, its plain version, SDPA on the same call, the
    bound (and, for a wgmma flash case, the simt kernel)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    for c in flash_cases:
        q, k, v = c["args"]
        causal = c["shape"][-1]
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal), 5)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                       causal=causal), 2)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 5)
        b_ms, b_by = flash_bound(*c["shape"], "bfloat16")
        simt = ""
        if c["kernel_route"] == "wgmma":
            c["simt_ms"] = cuda_ms(lambda: flash_kernel._launch(
                q, k, v, causal, "simt"), 3)
            simt = f", the simt kernel on the same call {c['simt_ms']:.4f} ms"
        c.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by)
        print(f"[time] flash_attention {c['what']}: {ms:.4f} ms per launch "
              f"({b_ms / ms:.3f} of the {b_by} bound), plain version "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}){simt}")
        del c["args"]
    for c in decode_cases:
        q, k, v, pos = c["args"]
        B, H, D = q.shape
        Sk, Kh, Dv = k.shape[1], k.shape[2], v.shape[3]
        ms = cuda_ms(lambda: decode_attention_fwd(q, k, v, pos), 20)
        plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, pos), 5)
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= pos[:, None])[:, None, None, :]
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], ks, vs, attn_mask=mask, enable_gqa=True), 20)
        b_ms, b_by = decode_bound(H, Kh, D, Dv, Sk, pos.tolist(), "bfloat16")
        c.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by)
        print(f"[time] decode_attention {c['what']}: {ms:.4f} ms per launch "
              f"({b_ms / ms:.3f} of the {b_by} bound), plain version "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by})")
        del c["args"]


def serve_direct(model, params, toks, S: int, extra: dict, dev,
                 new: int | None = None):
    """One request through the model's entry points as ``run_request``
    runs it (``init_cache`` of S + ``new`` rows, or as many as the frames,
    ``prefill`` with the stub input, greedy ``decode_step`` for ``new``
    tokens, each read back): (tokens, prefill s, decode s per token, last
    logits)."""
    import torch

    from repro_torch.models.model import init_cache
    from repro_torch.serve import engine as E

    cfg, new = model.cfg, new or SERVE_NEW
    torch.cuda.synchronize()
    t0 = time.time()
    rows = extra["frames"].shape[1] if "frames" in extra else S + new
    caches = init_cache(cfg, 1, rows, device=dev)
    logits, pre = model.prefill(params, {"tokens": toks[None, :S], **extra})
    caches = E._seed_caches(caches, pre, S)
    tok = logits.argmax(-1)[:, None]
    out = [int(tok[0, 0])]
    t1 = time.time()
    for t in range(S, S + new - 1):
        logits, caches = model.decode_step(params, caches, tok, t)
        tok = logits.argmax(-1)[:, None]
        out.append(int(tok[0, 0]))
    t2 = time.time()
    return out, t1 - t0, (t2 - t1) / (new - 1), logits


def model_card_equals_cpu(tag: str, cfg, dev, *, gate=None) -> None:
    """card == CPU at a reduced float32 config: the same weights (drawn on
    the CPU; a vlm gate set to ``gate``) and the same prompts of 40 and 24
    tokens with their stub inputs, 8 greedy tokens through ``prefill`` /
    ``decode_step`` on each; the tokens must be equal and the card must
    have launched the flash kernel."""
    import numpy as np
    import torch

    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model

    model = Model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(3))
    if gate is not None:
        for lay in p_cpu["stages"][0].values():
            if "gate" in lay["attn"]:
                lay["attn"]["gate"].fill_(gate)
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    rng = np.random.default_rng(8)
    before = flash_attention_fwd.launches
    for S in (40, 24):
        toks = rng.integers(1, cfg.vocab_size, S + 8)
        outs = []
        for device, params in (("cpu", p_cpu), (dev, p_dev)):
            t = torch.tensor(toks, device=device)
            extra = dvf.stub_inputs(cfg, dvf.frame_rows(cfg, S + 8), 9,
                                    device)
            outs.append(serve_direct(model, params, t, S, extra, device,
                                     new=8)[0])
        if outs[0] != outs[1]:
            fail(f"[{tag}] reduced float32 {cfg.name}: prompt {S} gives "
                 f"{outs[1]} on the card and {outs[0]} on the CPU")
    n = flash_attention_fwd.launches - before
    print(f"[{tag}] reduced float32 {cfg.name} ({cfg.num_layers} layers, "
          f"d={cfg.d_model}): card == CPU token for token on prompts 40 / "
          f"24, 8 tokens each ({n} flash_attention launches on the card)")
    if n < 1:
        fail(f"[{tag}] the reduced model launched no kernel on the card")


def xattn_path(dev) -> dict:
    """The cross-attention serving paths: seamless-m4t-large-v2 at full
    size (encoder-decoder) and ``vlm_cut`` of llama-3.2-vision-90b (its
    gate set to ``VLM_GATE``), two requests each (prompts 512 and 2048,
    SERVE_NEW greedy tokens) through ``init_cache`` / ``prefill`` /
    ``decode_step`` with the launch counts set to 0 just before and read
    just after; every flash and decode shape of the served passes held to
    its plain version on the card; decode-vs-forward layer by layer;
    times; card == CPU on the reduced float32 configs.  Returns
    {"flash": cases, "decode": cases, "launches": {arch: counts},
    "serve_s": {...}}."""
    import numpy as np
    import torch

    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import Model, init_cache
    from repro_torch.models.transformer import decoder_stages
    from repro_torch.serve import engine as E
    from repro_torch.serve.cuts import vlm_cut

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[serve-xattn] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated on entry (the hybrid phase's weights freed)")
    out = {"flash": [], "decode": [], "launches": {}, "serve_s": {}}
    for arch in XATTN_ARCHS:
        full = get_config(arch)
        cfg = vlm_cut(full) if full.family == "vlm" else full
        model = Model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
        gates = [lay["attn"]["gate"] for lay in params["stages"][0].values()
                 if "gate" in lay["attn"]]
        for g in gates:                 # zeros at init: tanh(0) = 0
            g.fill_(VLM_GATE)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        cut = (f"{full.name} cut to one block of {cfg.num_layers} layers "
               f"at full width (vlm_cut), cross-attention gate set to "
               f"{VLM_GATE}" if gates else "full size, not cut")
        print(f"[serve-xattn] {cfg.name}: {cut}; weights made on the card "
              f"in bfloat16 in {time.time() - t0:.1f} s: {n / 1e9:.3f} B "
              f"params, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"allocated")
        specs = [s for st in decoder_stages(cfg) for s in st.pattern
                 for _ in range(st.repeats)]
        per_prefill = len(specs) + sum(s.cross for s in specs) + (
            cfg.enc_layers if cfg.family == "encdec" else 0)
        per_token = len(specs) + sum(s.cross for s in specs)
        rng = np.random.default_rng(23)
        toks = torch.tensor(rng.integers(1, cfg.vocab_size,
                                         max(SERVE_PROMPTS)), device=dev)
        flash_attention_fwd.launches = decode_attention_fwd.launches = 0
        gmm.launches = 0
        for S in SERVE_PROMPTS:
            extra = dvf.stub_inputs(cfg, dvf.frame_rows(cfg, S + SERVE_NEW),
                                    31 + S, dev)
            res, t_pre, t_dec, logits = serve_direct(model, params, toks, S,
                                                     extra, dev)
            if len(res) != SERVE_NEW or not all(
                    0 <= t < cfg.vocab_size for t in res) or not bool(
                    torch.isfinite(logits).all()):
                fail(f"[serve-xattn] {cfg.name} prompt {S}: tokens {res}, "
                     f"finite logits {bool(torch.isfinite(logits).all())}")
            out["serve_s"][f"{cfg.name} {S}"] = dict(prefill=t_pre,
                                                     decode_per_token=t_dec)
            src = {k: tuple(v.shape) for k, v in extra.items()}
            print(f"[serve-xattn] {cfg.name} prompt {S} (source {src}): "
                  f"prefill {t_pre * 1e3:.1f} ms to the first token, "
                  f"decode {t_dec * 1e3:.2f} ms per token; first tokens "
                  f"{res[:8]}")
        counts = {"flash_attention": flash_attention_fwd.launches,
                  "decode_attention": decode_attention_fwd.launches,
                  "gmm": gmm.launches}
        k = len(SERVE_PROMPTS)
        want = {"flash_attention": per_prefill * k,
                "decode_attention": per_token * (SERVE_NEW - 1) * k,
                "gmm": 0}
        print(f"[serve-xattn] {cfg.name}: launches {counts} (expected "
              f"{want}: flash {per_prefill} per prefill"
              f"{' (encoder, decoder self and cross)' if cfg.enc_layers else ''}"
              f", decode {per_token} per token after the first)")
        if counts != want:
            fail(f"[serve-xattn] {cfg.name} launch counts {counts} differ "
                 f"from {want}")
        out["launches"][cfg.name] = counts
        print(f"[serve-xattn] {cfg.name} peak memory while serving "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

        # every flash and decode shape of the served passes, held to its
        # plain version on the model's own inputs
        kept, checked = [], {}
        for S in SERVE_PROMPTS:
            extra = dvf.stub_inputs(cfg, dvf.frame_rows(cfg, S + SERVE_NEW),
                                    31 + S, dev)
            with dvf.keep_flash_calls(kept), keep_decode_calls(checked):
                rows = (extra["frames"].shape[1] if "frames" in extra
                        else S + SERVE_NEW)
                caches = init_cache(cfg, 1, rows, device=dev)
                logits, pre = model.prefill(params, {"tokens": toks[None, :S],
                                                     **extra})
                caches = E._seed_caches(caches, pre, S)
                model.decode_step(params, caches, logits.argmax(-1)[:, None],
                                  S)
            del caches, pre
        fc, dc = attention_checks("serve-xattn", cfg.name, kept, checked)
        del kept, checked
        # the same decode shapes and positions on random N(0, 1) q, k, v:
        # the bf16 limit itself
        gen = torch.Generator(device=dev).manual_seed(37)
        for c in dc:
            q, k, v, pos = c["args"]
            rq, rk, rv = (torch.randn(t.shape, generator=gen, device=dev).to(
                torch.bfloat16) for t in (q, k, v))
            w = dvf.err_over_limit(decode_attention_fwd(rq, rk, rv, pos),
                                   decode_attention_ref(rq, rk, rv, pos))
            print(f"[kernel] decode_attention {c['what']} on random N(0, 1) "
                  f"q, k, v: largest err/limit {w:.3g} (1e-5 + 2^-6 |ref|)")
            if not w <= 1.0:
                fail(f"[serve-xattn] decode_attention {c['what']} on random "
                     f"inputs differs from its plain version: {w}")
            c["random_err_over_limit"] = w

        # decode-vs-forward: teacher forced, layer by layer (held), and
        # free running (printed); the frames as long as the decode cache,
        # so no zero row enters (R6)
        S = SERVE_PROMPTS[0] - 1
        extra = dvf.stub_inputs(cfg, dvf.frame_rows(cfg, S + dvf.PAD), 7,
                                dev)
        rel = dvf.layer_by_layer(model, params, toks, S, extra=extra)
        diff = dvf.free_running(model, params, toks, S, extra=extra)
        worst = max(range(len(rel)), key=rel.__getitem__)
        kinds = [("xattn" if s.kind == "xattn" else
                  "self+cross" if s.cross else s.kind) for s in specs]
        print(f"[serve-xattn] {cfg.name} decode-vs-forward, layer by layer: "
              f"decode at token {S} after prefill({S}), each layer fed "
              f"prefill({S + 1})'s input there: largest |diff| / max |row| "
              f"{rel[worst]:.5f} (layer {worst} of {len(rel)}, "
              f"{kinds[worst]}; bound {dvf.LAYER_TOL:g}); per layer "
              f"{[round(r, 5) for r in rel]}; free running, last logits max "
              f"abs diff {diff:.4f} (printed, not held)")
        if len(rel) != len(specs) or not rel[worst] <= dvf.LAYER_TOL:
            fail(f"[serve-xattn] {cfg.name} decode-vs-forward layer {worst}: "
                 f"{rel[worst]} > {dvf.LAYER_TOL}")
        time_attention(fc, dc)
        out["flash"] += fc
        out["decode"] += dc
        del model, params, gates
        torch.cuda.empty_cache()
        model_card_equals_cpu("serve-xattn", dataclasses.replace(
            full, compute_dtype="float32").reduced(), dev,
            gate=VLM_GATE if full.family == "vlm" else None)
    return out


def mla_path(dev) -> dict:
    """The MLA serving path: ``gmm`` against its plain version at
    deepseek-v3's expert shapes (E = 256; and timed there), then
    ``ServingEngine`` on ``mla_cut`` (two requests, prompts 512 and 2048,
    SERVE_NEW tokens) with the launch counts set to 0 just before and read
    just after, MLA's flash calls (D = 192, Dv = 128, the CUDA-core
    kernel) held to the plain version and timed, the dropped pairs, the
    teacher-forced per-layer decode-vs-forward, and card == CPU on a
    reduced float32 engine.  Returns {"gmm": cases, "flash": cases,
    "launches": counts, ...}."""
    import numpy as np
    import torch

    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.models import moe
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.transformer import decoder_stages
    from repro_torch.serve import engine as E
    from repro_torch.serve import kv_cache
    from repro_torch.serve.cuts import mla_cut

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    full = get_config(MLA_ARCH)
    cut = mla_cut(full)
    m = cut.moe
    gen = torch.Generator(device=dev).manual_seed(29)
    rng = np.random.default_rng(29)

    # -- [kernel] / [time] gmm at deepseek's expert shapes, E = 256 --------
    # a 2048-token prefill (C = 80), a 512-token one (C = 20) and one token
    # (C = 8) with skewed fills; the plain version one valid expert at a
    # time (a float32 gather of the whole [256, 7168, 2048] stack would
    # take 15 GB a call)
    gmm_cases = []
    for phase, T in (("prefill", max(SERVE_PROMPTS)),
                     ("prefill512", min(SERVE_PROMPTS)), ("decode", 1)):
        C = moe._capacity(m, T)
        bm = moe.block_m_for(C)
        Cp = (C + bm - 1) // bm * bm
        if T > 1:
            fill = rng.multinomial(T * m.top_k, rng.dirichlet(
                np.full(m.num_experts, 2.0)))
            fill[:4] = 0                           # some experts get nothing
        else:
            fill = np.zeros(m.num_experts, np.int64)
            fill[rng.choice(m.num_experts, m.top_k, replace=False)] = 1
        fill = np.minimum(fill, C)
        be, nv = moe._fill_blocks(torch.tensor(fill, device=dev), C, bm)
        valid = (nv > 0).cpu().numpy()
        rows = int(valid.sum()) * bm
        experts = int((fill > 0).sum())
        for proj, K, N in (("gate/up", cut.d_model, m.d_ff_expert),
                           ("down", m.d_ff_expert, cut.d_model)):
            x = torch.randn(m.num_experts * Cp, K, generator=gen,
                            device=dev).to(torch.bfloat16)
            w = torch.empty(m.num_experts, K, N, dtype=torch.bfloat16,
                            device=dev)
            for e in range(m.num_experts):
                w[e] = torch.randn(K, N, generator=gen, device=dev) / \
                    math.sqrt(K)
            res = gmm(x, w, be, nv, block_m=bm)
            torch.cuda.synchronize()
            route = gmm.last_route
            what = (f"deepseek {phase} {proj} E={m.num_experts} C={C} "
                    f"Cp={Cp} block_m={bm} K={K} N={N} bfloat16: "
                    f"{int(valid.sum())} of {len(valid)} blocks valid, "
                    f"{route} kernel")
            if route != gmm_want_route("bfloat16", bm):
                fail(f"gmm {what}: took the {route} kernel, not "
                     f"{gmm_want_route('bfloat16', bm)}")
            atol, rtol = ATTN_TOLS["bfloat16"]
            worst, err, zeros = gmm_vs_plain(res, x, w, be, nv, bm)
            print(f"[kernel] gmm {what}: max abs err {err:.3g}; limit "
                  f"{atol:g} + {rtol:g} |ref| per element (plain version "
                  f"one valid expert at a time), largest err/limit "
                  f"{worst:.3g}; skipped blocks exactly zero: {zeros}")
            if not (worst <= 1.0 and zeros):
                fail(f"gmm {what} differs from its plain version: max abs "
                     f"err {err}, largest err/limit {worst}, skipped "
                     f"blocks zero {zeros}")
            ms = cuda_ms(lambda: gmm(x, w, be, nv, block_m=bm), 5)
            xb = x.view(m.num_experts, Cp, K)
            lib_ms = cuda_ms(lambda: torch.bmm(xb, w), 3)
            b_ms, b_by = gmm_bound(rows, experts, x.shape[0], K, N,
                                   len(valid), "bfloat16")
            simt_ms = cuda_ms(lambda: gmm_kernel._launch(
                x, w, be, nv, bm, "simt"), 2)
            print(f"[time] gmm {what}: {ms:.4f} ms per launch ({b_ms / ms:.3f}"
                  f" of the {b_by} bound), torch.bmm over the [E, Cp, K] "
                  f"buffer {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                  f"the simt kernel on the same call {simt_ms:.4f} ms")
            gmm_cases.append(dict(what=what, dtype="bfloat16",
                                  kernel_route=route, err=err,
                                  err_over_limit=worst, ms=ms,
                                  library_ms=lib_ms, bound_ms=b_ms,
                                  bound_by=b_by, simt_ms=simt_ms))
            del x, w, res, xb
    torch.cuda.empty_cache()

    # -- [serve-mla] ServingEngine on the cut -------------------------------
    chips = kv_cache.chips_needed(cut, 1, 8192)
    classes = [E.RequestClass(SERVE_CLASSES[0][0],
                              get_config(SERVE_CLASSES[0][1]),
                              *SERVE_CLASSES[0][2:]),
               E.RequestClass("big", cut, 8192, chips, 4.0, 0.2)]
    print(f"[serve-mla] {cut.name}: {full.name} cut to its {m.first_dense} "
          f"dense and 2 MoE layers at full width, all {m.num_experts} "
          f"experts held, MTP off (mla_cut); needs {chips} chips at bucket "
          f"8192 (cache {kv_cache.cache_bytes(cut, 1, 8192) / 1e6:.1f} MB "
          f"of MLA latent); the uncut model {full.num_params() / 1e9:.1f} B "
          f"params")
    eng, runs, rng_s = admitted_big_runs(classes, "serve-mla", dev)
    model = eng._model("big")
    cfg = model.cfg
    t0 = time.time()
    params = eng._get_params("big")            # weights on the card: set-up
    torch.cuda.synchronize()
    f32 = sum(t.numel() for t in tree_leaves(params)
              if t.dtype == torch.float32)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve-mla] weights made on the card in {time.time() - t0:.1f} s:"
          f" {cfg.num_params() / 1e9:.2f} B params ({f32 / 1e6:.2f} M kept "
          f"in float32, the leaves read in float32), "
          f"{cfg.active_params() / 1e9:.2f} B active per token, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{init_peak:.2f} GB peak while drawing them")
    torch.cuda.reset_peak_memory_stats()
    specs = [s for st in decoder_stages(cfg) for s in st.pattern
             for _ in range(st.repeats)]
    n_moe = sum(s.ffn == "moe" for s in specs)
    L = len(specs)
    if moe._capacity(m, 1) < m.top_k:
        fail(f"decode capacity {moe._capacity(m, 1)} < top-k {m.top_k}")
    with KeptMoEInputs(moe, m) as kept:
        gmm.launches = flash_attention_fwd.launches = 0
        decode_attention_fwd.launches = 0
        t0 = time.time()
        walls = {}
        for S, jid in sorted(runs.items()):
            req = eng.run_request(jid)
            torch.cuda.synchronize()
            dropped = kept.drops(m.num_experts)[0]
            if len(req.output) != SERVE_NEW or not all(
                    0 <= t < cfg.vocab_size for t in req.output):
                fail(f"deepseek request {req.rid} (prompt {S}) gave tokens "
                     f"{req.output}")
            walls[S] = (req.prefill_s, req.decode_s / (SERVE_NEW - 1))
            print(f"[serve-mla] request {req.rid} prompt {S}: prefill "
                  f"{req.prefill_s * 1e3:.1f} ms to the first token, decode "
                  f"{walls[S][1] * 1e3:.2f} ms per token; {dropped} of "
                  f"{S * m.top_k * n_moe} (token, slot) pairs dropped in "
                  f"prefill (C = {moe._capacity(m, S)}, capacity factor "
                  f"{m.capacity_factor}); first tokens {req.output[:8]}")
        counts = {"gmm": gmm.launches,
                  "flash_attention": flash_attention_fwd.launches,
                  "decode_attention": decode_attention_fwd.launches}
        n = len(runs)
        want = {"gmm": 3 * n_moe * n * SERVE_NEW, "flash_attention": L * n,
                "decode_attention": 0}
        print(f"[serve-mla] {n} deepseek requests end to end in "
              f"{time.time() - t0:.1f} s; launches {counts} (expected "
              f"{want}: gmm 3 x {n_moe} per prefill and per token after the "
              f"first, flash {L} per prefill, decode_attention none: MLA "
              f"decodes in the absorbed form, plain torch products as the "
              f"reference's jnp.einsum)")
        if counts != want:
            fail(f"mla launch counts {counts} differ from {want}")
        for jid in runs.values():
            eng.complete(jid, 1.0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"[serve-mla] peak memory while serving {peak:.2f} GB of "
              f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}"
              f" GB ({init_peak:.2f} GB while drawing the weights)")

        # [kernel] MLA's flash calls (D = nope + rope, Dv = v) on the
        # model's own q, k, v at both prompt lengths
        toks = torch.tensor(rng_s.integers(1, cfg.vocab_size,
                                           max(SERVE_PROMPTS)), device=dev)
        fkept = []
        for S in SERVE_PROMPTS:
            with dvf.keep_flash_calls(fkept):
                model.prefill(params, {"tokens": toks[None, :S]})
            kept.drops(m.num_experts)
        fc, _ = attention_checks("serve-mla", cfg.name, fkept, {})
        del fkept

        # decode-vs-forward, teacher forced: each layer against the
        # prefill, held where the prefill's last token dropped no pair
        S = SERVE_PROMPTS[0] - 1
        rel = dvf.layer_by_layer(model, params, toks, S)
        last = kept.last_token_drops(m.num_experts)[:n_moe]
        kept.saved.clear()
    diff = dvf.free_running(model, params, toks, S)
    dropped_at = {}
    j = 0
    for i, s in enumerate(specs):
        if s.ffn == "moe":
            dropped_at[i] = last[j]
            j += 1
    held = [i for i in range(L) if not dropped_at.get(i)]
    worst = max(held, key=rel.__getitem__) if held else None
    print(f"[serve-mla] {cut.name} decode-vs-forward, layer by layer: decode "
          f"at token {S} after prefill({S}) (absorbed MLA against the "
          f"latent cache), each layer fed prefill({S + 1})'s input there "
          f"(expanded MLA, flash at D = {cfg.mla.nope_dim + cfg.mla.rope_dim}"
          f"): |diff| / max |row| per layer {[round(r, 5) for r in rel]}; "
          f"the last token's pairs dropped in prefill({S + 1}) by MoE layer "
          f"{dropped_at}; held to {dvf.LAYER_TOL:g}: layers {held}, largest "
          f"{rel[worst] if worst is not None else None}; free running, last "
          f"logits max abs diff {diff:.4f} (printed, not held)")
    if len(rel) != L:
        fail(f"[serve-mla] {len(rel)} layers compared of {L}")
    time_attention(fc, [])
    del eng, params, model
    torch.cuda.empty_cache()

    # card == CPU: a reduced float32 engine with the same weights
    card_equals_cpu([E.RequestClass(SERVE_CLASSES[0][0], dataclasses.replace(
        get_config(SERVE_CLASSES[0][1]), compute_dtype="float32").reduced(),
        *SERVE_CLASSES[0][2:]),
        E.RequestClass("big", dataclasses.replace(
            cut, compute_dtype="float32").reduced(), 8192, chips, 4.0, 0.2)],
        "serve-mla", (64, 40), gmm, dev)
    # held last, once everything above has printed
    if worst is not None and not rel[worst] <= MLA_LAYER_TOL:
        fail(f"[serve-mla] decode-vs-forward layer {worst}: {rel[worst]} > "
             f"{MLA_LAYER_TOL}")
    return dict(gmm=gmm_cases, flash=fc, launches=counts,
                serve_s={f"prompt {S}": {"prefill": p, "decode_per_token": d}
                         for S, (p, d) in sorted(walls.items())})


@contextlib.contextmanager
def keep_gmm_calls(checked: dict):
    """While active (``with``), each gmm call of the model code
    (``models.moe.gmm``) is held at once to its plain version on the same
    inputs (``gmm_vs_plain``).  ``checked`` maps the call's shape (M, E,
    K, N, block_m, route) to [calls, largest err/limit, largest abs err,
    skipped blocks zero]."""
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.models import moe

    def keeping(x, w, be, nv, *, block_m):
        out = gmm(x, w, be, nv, block_m=block_m)
        key = (x.shape[0], w.shape[0], x.shape[1], w.shape[2], block_m,
               gmm.last_route)
        worst, err, zeros = gmm_vs_plain(out, x, w, be, nv, block_m)
        c = checked.setdefault(key, [0, 0.0, 0.0, True])
        c[0] += 1
        c[1], c[2], c[3] = max(c[1], worst), max(c[2], err), c[3] and zeros
        return out

    moe.gmm = keeping
    try:
        yield checked
    finally:
        moe.gmm = gmm


@contextlib.contextmanager
def plain_epoch_runs():
    """``PLAIN_EPOCHS`` for each policy, one process each, all started at
    once so that they run while the card serves; yields {policy: Popen}
    and kills whichever still runs on the way out."""
    path = os.pathsep.join(filter(None, (str(ROOT / "src"),
                                         os.environ.get("PYTHONPATH"))))
    procs = {pol: subprocess.Popen(
        [sys.executable, "-c", PLAIN_EPOCHS, pol, json.dumps(DRIVER_KW)],
        stdout=subprocess.PIPE, env=dict(os.environ, PYTHONPATH=path))
        for pol in POLICIES}
    try:
        yield procs
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


def driver_path(dev, report: dict, plain: dict) -> dict:
    """The serving driver (``repro_torch.launch.serve``) on the card.

    1. ``run_epochs`` at the driver's defaults (``DRIVER_KW``) for each
       policy, the stream counts set to 0 just before and read just after
       (one carried launch a chunk); the epoch and rescale lines printed;
       at least one rescale; every printed line and every
       ``StreamResult`` field equal bit for bit to the CPU's (``plain``:
       ``plain_epoch_runs``' processes, read at the end of the phase), and
       ``main``'s epoch loop (bs-fcfs) too.
    2. ``main([... "--execute", DRIVER_EXECUTE])``: every kernel count set
       to 0 just before and read just after; every flash, decode and gmm
       call held to its plain version (``keep_flash_calls``,
       ``keep_decode_calls``, ``keep_gmm_calls``); flash L a prefill,
       decode L a token after the first, gmm 3 a MoE layer a prefill and
       a token; each request's prefill and decode wall, each class's
       weight draw and the peak memory printed.
    3. starcoder2-7b's layer-by-layer decode-vs-forward within
       ``dvf.LAYER_TOL`` (G = 9 in both attention kernels).
    4. a ``llamav-32k`` request raises ``KeyError`` with
       ``torch.cuda.memory_allocated()`` unchanged.

    Adds ``driver_launches`` to the stream entries of ``report``; returns
    {"flash": cases, "decode": cases, "gmm": cases, "launches": counts,
    "serve_s": walls, ...}."""
    import numpy as np
    import torch

    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba_scan import (mamba_scan_fused,
                                                mamba_scan_fwd)
    from repro_torch.kernels.msj_scan import kernel as K
    from repro_torch.kernels.rwkv6 import wkv_fwd
    from repro_torch.launch import serve as D
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.transformer import decoder_stages
    from repro_torch.serve import engine as E

    t_phase = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[serve-driver] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated on entry (the MLA phase's weights freed)")

    def say(line):
        for s in line.splitlines():
            print(f"[serve-driver] {s}")

    # -- 1. the epoch loop on the carried stream kernels ------------------
    classes = D.default_classes(DRIVER_KW["fleet"], dev)
    wrappers = {pol: STREAM_KERNELS[name][0]
                for pol, name in zip(POLICIES, STREAM_KERNELS)}
    n_chunks = DRIVER_KW["epochs"] * -(-DRIVER_KW["epoch_jobs"]
                                       // DRIVER_KW["chunk_jobs"])
    driver_launches, epoch_s, counted = {}, {}, {}
    for pol in POLICIES:
        lines = []
        torch.cuda.synchronize()
        t0 = time.time()
        K.reset_launches()
        hist = D.run_epochs(classes, policy=pol, device=dev,
                            out=lines.append, **DRIVER_KW)
        counts = {w: n for w, n in K.launches().items() if n}
        epoch_s[pol] = time.time() - t0
        for line in lines:
            say(f"{pol}: {line}")
        want = {wrappers[pol]: n_chunks}
        print(f"[serve-driver] run_epochs({pol}) at the driver's defaults "
              f"{DRIVER_KW}: {epoch_s[pol]:.2f} s; launches {counts} "
              f"(expected {want}: one carried launch a chunk)")
        if counts != want:
            fail(f"[serve-driver] run_epochs({pol}) launched {counts}, "
                 f"expected {want}")
        for k, res in hist:
            for f in STREAM_FIELDS:
                x = getattr(res, f)
                if x is not None and not np.isfinite(x).all():
                    fail(f"[serve-driver] {pol} k={k}: non-finite {f}")
        if not any(s.startswith("rescale:") for s in lines):
            fail(f"[serve-driver] run_epochs({pol}): no rescale at the "
                 f"driver's defaults")
        counted[pol] = (lines, hist)
        driver_launches[wrappers[pol]] = counts.get(wrappers[pol], 0)
    for name, (wrapper, _) in STREAM_KERNELS.items():
        report[name]["driver_launches"] = driver_launches[wrapper]

    # -- 2. main --execute on the card --------------------------------------
    draw_s = {}
    get_params = E.ServingEngine._get_params

    def timed_get_params(self, name):
        if name in self._params:
            return get_params(self, name)
        torch.cuda.synchronize()
        t0 = time.time()
        out = get_params(self, name)
        torch.cuda.synchronize()
        draw_s[name] = time.time() - t0
        return out

    wrappers_all = {"flash_attention": flash_attention_fwd,
                    "decode_attention": decode_attention_fwd,
                    "gmm": moe_gmm.gmm, "wkv": wkv_fwd,
                    "mamba_scan": mamba_scan_fused,
                    "mamba_scan_reference_entry": mamba_scan_fwd}
    argv = ["--execute", str(DRIVER_EXECUTE)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    E.ServingEngine._get_params = timed_get_params
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            K.reset_launches()
            for w in wrappers_all.values():
                w.launches = 0
            t0 = time.time()
            hist, eng = D.main(argv)
            torch.cuda.synchronize()
            main_s = time.time() - t0
            counts = {n: w.launches for n, w in wrappers_all.items()}
            counts.update({w: n for w, n in K.launches().items() if n})
    finally:
        E.ServingEngine._get_params = get_params
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(buf.getvalue())
    reqs = sorted(eng._jobs.values(), key=lambda r: r.rid)
    names = [r.cls_name for r in reqs]
    print(f"[serve-driver] main({argv}) on the card in {main_s:.1f} s "
          f"(the epoch loop at the defaults, bs-fcfs, then {len(reqs)} "
          f"requests); draws {names}")
    if names != DRIVER_DRAWS:
        fail(f"[serve-driver] --execute drew {names}, expected {DRIVER_DRAWS}")
    want = {"flash_attention": 0, "decode_attention": 0, "gmm": 0, "wkv": 0,
            "mamba_scan": 0, "mamba_scan_reference_entry": 0,
            wrappers["bs-fcfs"]: n_chunks}
    first = {}                           # class -> its first request
    for r in reqs:
        cfg = eng._model(r.cls_name).cfg
        specs = [s for st in decoder_stages(cfg) for s in st.pattern
                 for _ in range(st.repeats)]
        L = len(specs)
        n_moe = sum(s.ffn == "moe" for s in specs)
        new = len(r.output) - 1
        want["flash_attention"] += L
        if cfg.mla is None:
            want["decode_attention"] += L * new
        want["gmm"] += 3 * n_moe * (1 + new)
        if len(r.output) != 16 or not all(0 <= t < cfg.vocab_size
                                           for t in r.output):
            fail(f"[serve-driver] request {r.rid} ({r.cls_name}) gave "
                 f"tokens {r.output}")
        drawn = ("" if r.cls_name in first else
                 f"; weights drawn in {draw_s[r.cls_name]:.2f} s")
        first.setdefault(r.cls_name, r)
        print(f"[serve-driver] request {r.rid} {r.cls_name} ({cfg.name}, "
              f"{L} layers, H={cfg.num_heads} Kh={cfg.num_kv_heads}): prefill "
              f"of 16 tokens {r.prefill_s * 1e3:.1f} ms, decode "
              f"{r.decode_s / new * 1e3:.2f} ms per token{drawn}; tokens "
              f"{r.output}")
    print(f"[serve-driver] launches {counts} (expected {want}: the epoch "
          f"loop's {n_chunks} carried launches, flash L a prefill, decode L "
          f"a token after the first (none for MLA: absorbed decode), gmm 3 "
          f"a MoE layer a prefill and a token)")
    if counts != want:
        fail(f"[serve-driver] launch counts {counts} differ from {want}")
    weights = {n: round(sum(t.numel() * t.element_size() for t in
                            tree_leaves(eng._params[n])) / 1e9, 2)
               for n in eng._params}
    print(f"[serve-driver] weights held {weights} GB; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
          f"{peak:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
          f"in main")

    # the first request of each class again, warm and then with every
    # flash, decode and gmm call held to its plain version (launches made
    # to compare, outside the counted run): the same tokens both times
    fkept, dec_checked, gmm_checked, warm = [], {}, {}, {}
    for held in (False, True):
        with contextlib.ExitStack() as stack:
            if held:
                stack.enter_context(dvf.keep_flash_calls(fkept))
                stack.enter_context(keep_decode_calls(dec_checked))
                stack.enter_context(keep_gmm_calls(gmm_checked))
            for name, r in first.items():
                rid = max(q.rid for q in eng._jobs.values()) + 1
                eng.submit(E.Request(rid=rid, cls_name=name, prompt=r.prompt,
                                     arrival=float(rid)), float(rid))
                again = eng.run_request(max(eng._jobs))
                torch.cuda.synchronize()
                if again.output != r.output:
                    fail(f"[serve-driver] request {r.rid} ({name}) run again "
                         f"{'held' if held else 'warm'} gave {again.output}, "
                         f"not {r.output}")
                if not held:
                    warm[name] = (again.prefill_s, again.decode_s
                                  / (len(again.output) - 1))
    print(f"[serve-driver] the first request of each class again, warm: "
          + ", ".join(f"{n} prefill {p * 1e3:.1f} ms, decode {d * 1e3:.2f} ms "
                      f"per token" for n, (p, d) in warm.items())
          + "; again with every kernel call held to its plain version: the "
            "same tokens")

    # one line per decode shape: the held calls at every position merged,
    # the last position's inputs kept for timing
    merged = {}
    for key, (calls, unit, scaled, err, args) in dec_checked.items():
        m = merged.setdefault(key[:6], [0, 0.0, 0.0, 0.0, None, None])
        m[0] += calls
        m[1], m[2], m[3] = max(m[1], unit), max(m[2], scaled), max(m[3], err)
        m[4], m[5] = args, key[6]
    print(f"[serve-driver] decode calls held at positions "
          f"{sorted({k[6][0] for k in dec_checked})[0]}.."
          f"{sorted({k[6][0] for k in dec_checked})[-1]}, merged by shape "
          f"(pos below is the last one's, whose inputs are timed)")
    dec_checked = {k + (m[5],): m[:5] for k, m in merged.items()}
    fc, dc = attention_checks("serve-driver", "driver", fkept, dec_checked)
    gmm_cases = []
    for (M, Ex, Kd, N, bm, route), (calls, worst, err, zeros) in \
            gmm_checked.items():
        what = (f"driver M={M} E={Ex} K={Kd} N={N} block_m={bm} bfloat16, "
                f"{route} kernel")
        print(f"[kernel] gmm {what}: {calls} calls of the served requests "
              f"against the plain version one valid expert at a time: "
              f"largest err/limit {worst:.3g}, max abs err {err:.3g}; "
              f"skipped blocks exactly zero: {zeros}")
        if route != gmm_want_route("bfloat16", bm):
            fail(f"[serve-driver] gmm {what}: expected the "
                 f"{gmm_want_route('bfloat16', bm)} kernel")
        if not (worst <= 1.0 and zeros):
            fail(f"[serve-driver] gmm {what} differs from its plain version")
        gmm_cases.append(dict(what=what, err=err, err_over_limit=worst,
                              calls=calls, kernel_route=route))
    heads = {(c["shape"][3], c["shape"][4]) for c in fc}
    if (36, 4) not in heads or not any(k[2:4] == (36, 4) for k in
                                       dec_checked):
        fail("[serve-driver] no G = 9 flash or decode call was held")
    del fkept
    time_attention(fc, dc)

    # -- 3. starcoder2-7b decode-vs-forward, layer by layer -----------------
    name = "starcoder-8k"
    model, params = eng._model(name), eng._params[name]
    cfg = model.cfg
    rng = np.random.default_rng(31)
    toks = torch.tensor(rng.integers(1, cfg.vocab_size,
                                     SERVE_PROMPTS[0]), device=dev)
    S = SERVE_PROMPTS[0] - 1
    rel = dvf.layer_by_layer(model, params, toks, S)
    diff = dvf.free_running(model, params, toks, S)
    worst = max(range(len(rel)), key=rel.__getitem__)
    print(f"[serve-driver] {cfg.name} (G = {cfg.num_heads // cfg.num_kv_heads}"
          f") decode-vs-forward, layer by layer: decode at token {S} after "
          f"prefill({S}), each layer fed prefill({S + 1})'s input there: "
          f"largest |diff| / max |row| {rel[worst]:.5f} (layer {worst} of "
          f"{len(rel)}; bound {dvf.LAYER_TOL:g}); free running, last logits "
          f"max abs diff {diff:.4f} (printed, not held)")
    if len(rel) != cfg.num_layers or not rel[worst] <= dvf.LAYER_TOL:
        fail(f"[serve-driver] {cfg.name} decode-vs-forward layer {worst}: "
             f"{rel[worst]} > {dvf.LAYER_TOL}")

    # -- 4. a llamav-32k request: KeyError before its weights ---------------
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rid = max(q.rid for q in eng._jobs.values()) + 1
    eng.submit(E.Request(rid=rid, cls_name="llamav-32k",
                         prompt=np.arange(16), arrival=float(rid)), float(rid))
    try:
        eng.run_request(max(eng._jobs))
    except KeyError as e:
        raised = e
    else:
        raised = None
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"[serve-driver] llamav-32k request {rid}: raised "
          f"{type(raised).__name__}{raised.args if raised else ''}; "
          f"memory_allocated {before} -> {after} bytes; llamav weights held: "
          f"{'llamav-32k' in eng._params}")
    if type(raised) is not KeyError or after != before or \
            "llamav-32k" in eng._params:
        fail("[serve-driver] the llamav-32k request did not raise KeyError "
             "before allocating")
    main_out = buf.getvalue()
    del eng, params, model

    # -- the epoch loops against their plain versions on the CPU -----------
    t0 = time.time()
    plain_s = {}
    for pol, proc in plain.items():
        got, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"[serve-driver] run_epochs({pol}) on the CPU exited "
                 f"{proc.returncode}")
        lp, hp, plain_s[pol] = pickle.loads(got)
        want = "".join(f"{s}\n" for s in lp)
        lines, hc = counted[pol]
        runs = [("the counted run", "".join(f"{s}\n" for s in lines), hc)]
        if pol == "bs-fcfs":      # main printed them first
            runs.append(("main's", main_out[:len(want)], hist))
        for what, text, hc in runs:
            if text != want:
                fail(f"[serve-driver] run_epochs({pol}), {what}: printed "
                     f"lines differ on the card and the CPU:\n{text}\n"
                     f"{want}")
            if [k for k, _ in hc] != [k for k, _ in hp]:
                fail(f"[serve-driver] run_epochs({pol}), {what}: fleet "
                     f"sizes differ")
            for (k, a), (_, b) in zip(hc, hp):
                for f in ("jobs", "reps") + STREAM_FIELDS:
                    x, y = getattr(a, f), getattr(b, f)
                    if (x is None) != (y is None) or (x is not None and (
                            np.asarray(x).tobytes()
                            != np.asarray(y).tobytes())):
                        fail(f"[serve-driver] run_epochs({pol}), {what}, "
                             f"k={k}: {f} on the card differs from the CPU")
        print(f"[serve-driver] run_epochs({pol}) at the driver's defaults: "
              f"{' and '.join(w for w, _, _ in runs)} on the card == the CPU "
              f"plain version on every printed line ({len(lp)}, "
              f"{sum(s.startswith('rescale:') for s in lp)} rescales) and "
              f"every StreamResult field bit for bit; CPU plain version "
              f"{plain_s[pol]:.2f} s on one thread")
    print(f"[serve-driver] waited {time.time() - t0:.1f} s for the CPU runs "
          f"(started with the phase)")
    del hist
    print(f"[serve-driver] the driver phase took {time.time() - t_phase:.1f} s")
    return dict(flash=fc, decode=dc, gmm=gmm_cases, launches=counts,
                epoch_s=epoch_s, plain_epoch_s=plain_s, peak_gb=peak,
                draw_s=draw_s,
                warm_s={n: {"prefill": p, "decode_per_token": d}
                        for n, (p, d) in warm.items()},
                serve_s={f"request {r.rid} {r.cls_name}": {
                    "prefill": r.prefill_s,
                    "decode_per_token": r.decode_s / (len(r.output) - 1)}
                    for r in reqs})


TRAIN_ARCH = "stablelm_3b"
# (arch, H, Kh, D, Dv, B, dtype): the flash backward kernel's cases at
# the trained model's call (stablelm-3b, B 4, S 2048) and at the served
# models' heads (yi-9b G 8, starcoder2-7b G 9, deepseek-v3's MLA D 192 /
# Dv 128), causal at S = TRAIN_S, and one float32 case
BWD_CASES = (("stablelm_3b", 32, 32, 80, 80, 4, "bfloat16"),
             ("yi_9b", 32, 4, 128, 128, 1, "bfloat16"),
             ("starcoder2_7b", 36, 4, 128, 128, 1, "bfloat16"),
             ("deepseek_v3_671b", 128, 128, 192, 128, 1, "bfloat16"),
             ("stablelm_3b", 32, 32, 80, 80, 1, "float32"))
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 4
FLASH_BWD = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_bwd.cu", "src/repro/models/layers.py:269")
# reduced configs whose kernels have no backward yet: a train step on the
# card must raise naming the kernel
REFUSED = (("moonshot_v1_16b_a3b", "gmm"), ("rwkv6_7b", "wkv"),
           ("jamba_1_5_large_398b", "mamba_scan"))


def flash_bwd_bound(B, S, H, Kh, D, Dv, dtype):
    """Least time for one causal flash backward: q, k, v, o, do read once
    (and lse), dq, dk, dv written once; five products a kept (query, key)
    pair, q.k, do.v, ds.k, p.do, ds.q: 2 (3 D + 2 Dv) flops."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (item * (B * S * H * (2 * D + 3 * Dv) + 2 * B * S * Kh
                      * (D + Dv)) + 4 * B * H * S)
    kept = S * (S + 1) // 2
    return _roofline(nbytes, 2 * B * H * kept * (3 * D + 2 * Dv), dtype)


def train_path(dev, report: dict) -> None:
    """Training on the card (``[train]``).

    1. ``flash_attention_bwd`` (three kernels: delta, dq, dk / dv) against
       its plain version at ``BWD_CASES``, within
       ``train_cases.BWD_TOLS``, with its device time beside the bound,
       the plain version's time and the backward of
       ``scaled_dot_product_attention`` through autograd (a yardstick the
       port never calls); both forward routes' lse against the plain lse.
    2. stablelm-3b at full size (2.796 B params, 32 layers) through the
       port's ``Trainer``: global batch 4, sequence 2048, four steps at
       microbatches 1 with the flash counts set to 0 just before and read
       just after (forward 2 x 32 a microbatch: the remat recompute; the
       backward 32), then four at microbatches 2; per step the loss,
       grad_norm, lr and wall, then tokens/s, 6 N tokens / wall against
       989 TFLOP/s and the peak memory; the first step's backward calls of
       layers 31 and 0 held to the plain version on their own inputs.
    3. reduced stablelm-3b and yi-9b in float32 compute: three train steps
       on the card against the same steps on the CPU (``STEP_TOLS``).
    4. the restart drill (reduced stablelm-3b, bf16 compute): killed after
       step 3, restarted from its step-2 checkpoint, bit-equal to the run
       never killed.
    5. reduced moonshot (MoE), rwkv6 and jamba: a train step raises
       ``NotImplementedError`` naming ``gmm`` / ``wkv`` / ``mamba_scan``,
       and their ``loss_fn`` under ``torch.no_grad`` runs; the launcher
       at reduced size on the card.

    Adds ``flash_attention_bwd`` to ``report`` and the train launches to
    ``flash_attention``'s entry."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.bench import train_cases as tc
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_train_batches
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_fwd,
                                                     flash_attention_ref)
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    t_phase = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[train] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"on entry")
    gen = torch.Generator(device=dev)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 1. the backward kernel against its plain version -------------------
    cases, worst = [], 0.0
    for arch, H, Kh, D, Dv, B, dtype in BWD_CASES:
        gen.manual_seed(len(cases))
        dt = getattr(torch, dtype)
        S = TRAIN_S
        q, k, v = (randn(s, dt) for s in ((B, S, H, D), (B, S, Kh, D),
                                          (B, S, Kh, Dv)))
        do = randn((B, S, H, Dv), dt)
        o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        route = flash_attention_fwd.last_route
        o_ref, lse_ref = flash_attention_ref(q, k, v, causal=True,
                                             return_lse=True)
        lse_err = (lse - lse_ref).abs().max().item()
        if not torch.allclose(lse, lse_ref, atol=1e-5, rtol=1e-5):
            fail(f"[train] lse of the {route} forward at {arch} {dtype}: "
                 f"max err {lse_err}")
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
        errs = [tc.bwd_error(g, w, dtype) for g, w in zip(got, want)]
        over = max(e[0] for e in errs)
        err = max(e[1] for e in errs)
        what = (f"{arch} B={B} S={S} H={H} Kh={Kh} D={D} Dv={Dv} causal "
                f"{dtype}")
        print(f"[kernel] flash_attention_bwd {what}: max abs err {err:.3g} "
              f"(dq, dk, dv {', '.join(f'{e[1]:.3g}' for e in errs)}); "
              f"limit {tc.BWD_TOLS[dtype][0]:g} max|ref| + "
              f"{tc.BWD_TOLS[dtype][1]:g} |ref|, {over:.3f} of it; lse of "
              f"the {route} forward max err {lse_err:.3g}")
        if not over <= 1.0:
            fail(f"[train] flash_attention_bwd {what}: {over} of its limit")
        del got, want, o_ref
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=True), 3)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=True), 2)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 3)
        del out, qt, kt, vt
        b_ms, b_by = flash_bwd_bound(B, S, H, Kh, D, Dv, dtype)
        print(f"[time] flash_attention_bwd {what}: {ms:.4f} ms per launch "
              f"({b_ms / ms:.4f} of the bound), bound {b_ms:.5f} ms "
              f"({b_by}), plain version {plain_ms:.4f} ms, SDPA backward "
              f"{lib_ms:.4f} ms ({ms / lib_ms:.1f} x)")
        cases.append(dict(what=what, err=err, over=over, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, lse_err=lse_err,
                          fwd_route=route))
        worst = max(worst, err)
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()

    # -- 2. stablelm-3b at full size through the Trainer --------------------
    cfg = get_config(TRAIN_ARCH)
    n_params = Model(cfg).num_params()
    L = cfg.num_layers
    runs, layer_checks = {}, []
    for M in (1, 2):
        trainer = Trainer(cfg, TRAIN_B, TRAIN_S, microbatches=M,
                          log_every=1, device=dev,
                          opt_cfg=AdamWConfig(total_steps=TRAIN_STEPS))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt = trainer.init_state()
        torch.cuda.synchronize()
        draw_s = time.time() - t0
        kept, stamps = {}, []
        real_bwd = layers.flash_attention_bwd
        calls = [0]

        def keeping(q, k, v, o, lse, do, *, causal):
            out = real_bwd(q, k, v, o, lse, do, causal=causal)
            if M == 1 and calls[0] in (0, L - 1):   # layers 31 and 0
                kept[L - 1 - calls[0]] = (
                    tuple(t.clone() for t in (q, k, v, o, lse, do)),
                    tuple(t.clone() for t in out))
            calls[0] += 1
            return out

        trainer.on_metrics = lambda s, m: stamps.append((time.time(), m))
        layers.flash_attention_bwd = keeping
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        try:
            t1 = time.time()
            res = trainer.run(TRAIN_STEPS, params=params, opt_state=opt)
        finally:
            layers.flash_attention_bwd = real_bwd
        counts = {"flash_attention": flash_attention_fwd.launches,
                  "flash_attention_bwd": flash_attention_bwd.launches}
        peak = torch.cuda.max_memory_allocated() / 1e9
        walls = np.diff([t1] + [t for t, _ in stamps])
        for (t, m), w in zip(stamps, walls):
            print(f"[train] {cfg.name} M={M} step {m['step']}: loss "
                  f"{m['loss']:.4f} grad_norm {m['grad_norm']:.4f} lr "
                  f"{m['lr']:.3e} wall {w:.3f} s")
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                    and m["grad_norm"] > 0):
                fail(f"[train] M={M} step {m['step']}: loss {m['loss']} "
                     f"grad_norm {m['grad_norm']}")
        steady = float(np.mean(walls[1:]))
        tok_s = TRAIN_B * TRAIN_S / steady
        frac = 6 * n_params * TRAIN_B * TRAIN_S / steady / 989e12
        want = {"flash_attention": TRAIN_STEPS * 2 * L * M,
                "flash_attention_bwd": TRAIN_STEPS * L * M}
        print(f"[train] {cfg.name} ({n_params / 1e9:.3f} B params, {L} "
              f"layers, d={cfg.d_model}, remat {cfg.remat_policy}) B="
              f"{TRAIN_B} S={TRAIN_S} microbatches {M}: params drawn in "
              f"{draw_s:.1f} s; first step {walls[0]:.3f} s, then "
              f"{steady:.3f} s a step ({tok_s:.0f} tokens/s, 6 N tokens / "
              f"wall = {frac:.4f} of 989 TFLOP/s); peak memory {peak:.2f} "
              f"GB; launches {counts} (expected {want}: the forward twice "
              f"a layer a microbatch, remat, the backward once)")
        if counts != want:
            fail(f"[train] M={M} launches {counts}, expected {want}")
        runs[M] = dict(first_s=float(walls[0]), step_s=steady,
                       tokens_per_s=tok_s, flops_frac=frac, peak_gb=peak,
                       launches=counts, draw_s=draw_s,
                       loss=[m["loss"] for _, m in stamps],
                       grad_norm=[m["grad_norm"] for _, m in stamps])
        del trainer, params, opt, res, stamps
        gc.collect()
        torch.cuda.empty_cache()
        for layer in sorted(kept):
            ins, out = kept[layer]
            want_out = flash_attention_bwd_ref(*ins, causal=True)
            errs = [tc.bwd_error(g, w, "bfloat16")
                    for g, w in zip(out, want_out)]
            over = max(e[0] for e in errs)
            big = max(w.float().abs().max().item() for w in want_out)
            print(f"[kernel] flash_attention_bwd {cfg.name} layer {layer}'s "
                  f"first-step call (B={TRAIN_B} S={TRAIN_S}, its own q, k, "
                  f"v, o, lse, do): max abs err "
                  f"{max(e[1] for e in errs):.3g} at max|ref| {big:.3g}, "
                  f"{over:.3f} of the limit")
            if not over <= 1.0:
                fail(f"[train] layer {layer}'s backward call: {over} of its "
                     f"limit")
            layer_checks.append(dict(layer=layer, max_abs_err=max(
                e[1] for e in errs), max_ref=big, of_limit=over))
        del kept
        torch.cuda.empty_cache()
    if len(runs[1]["loss"]) < TRAIN_STEPS:
        fail("[train] fewer steps than asked")

    # -- 3. reduced configs: card == CPU -------------------------------------
    for arch in ("stablelm_3b", "yi_9b"):
        rcfg = tc.reduced_float32(get_config(arch))
        p0 = tc.rescale_attention(rcfg, Model(rcfg).init(
            torch.Generator().manual_seed(0)))
        card = tc.run_steps(rcfg, p0, 3, device=dev)
        cpu = tc.run_steps(rcfg, p0, 3, device="cpu")
        diff = tc.steps_differ(card[1], cpu[1], card[0], cpu[0])
        print(f"[train] {rcfg.name} float32, 3 steps card vs CPU: loss "
              f"{[round(h['loss'], 5) for h in card[1]]}; largest "
              f"differences {diff} (limits {tc.STEP_TOLS})")
        if not tc.within_step_tols(diff):
            fail(f"[train] {rcfg.name} card differs from the CPU: {diff}")

    # -- 4. the restart drill ------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        restarts, same, drill, whole = tc.restart_drill(
            get_config(TRAIN_ARCH).reduced(), d, device=dev)
    print(f"[train] restart drill ({TRAIN_ARCH} reduced, bf16, 6 steps, "
          f"failure after step 3, ckpt_every 2): {restarts} restart, "
          f"resumed at step {drill[0]['step']}; params and moments "
          f"bit-equal to the run never killed: {same}")
    if restarts != 1 or not same:
        fail("[train] the restarted run differs from the uninterrupted one")

    # -- 5. kernels without a backward refuse; the launcher ------------------
    for arch, kernel in REFUSED:
        rcfg = get_config(arch).reduced()
        params, opt = init_train_state(rcfg, torch.Generator(
            device=dev).manual_seed(0))
        batch = next(make_train_batches(rcfg, 2, 32, device=dev))[1]
        try:
            make_train_step(rcfg, AdamWConfig())(params, opt, batch)
            fail(f"[train] {rcfg.name}: a train step ran on the card")
        except NotImplementedError as e:
            if kernel not in str(e):
                fail(f"[train] {rcfg.name} raised for another kernel: {e}")
            msg = str(e).split(":")[0]
        with torch.no_grad():
            loss, met = Model(rcfg).loss(params, batch)
        if not torch.isfinite(loss):
            fail(f"[train] {rcfg.name}: loss under no_grad {loss}")
        print(f"[train] {rcfg.name}: a train step raises "
              f"NotImplementedError ({msg}: no backward kernel yet); "
              f"loss_fn under no_grad {float(loss):.4f}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(["--arch", TRAIN_ARCH, "--reduced", "--steps",
                           "3", "--batch", "2", "--seq", "64",
                           "--microbatches", "2"])
    for line in buf.getvalue().splitlines():
        print(f"[train] launch.train --reduced on the card: {line}")

    report["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda", source=FLASH_BWD[0],
        replaces=FLASH_BWD[1], launches=runs[1]["launches"][
            "flash_attention_bwd"],
        max_abs_err=worst, ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
        bound_ms=cases[0]["bound_ms"], bound_by=cases[0]["bound_by"],
        library_ms=cases[0]["library_ms"], shape=cases[0]["what"],
        cases=cases[1:], train=runs, train_layer_checks=layer_checks)
    report["flash_attention"]["train_launches"] = runs[1]["launches"][
        "flash_attention"]
    print(f"[train] phase in {time.time() - t_phase:.1f} s")


def tensor_core_instructions(paths) -> None:
    """Print, for each kernel of each built library, its tensor-core
    instructions (HGMMA: wgmma; HMMA: mma.sync) in ``cuobjdump
    --dump-sass``; fail if an instantiation of a tensor-core kernel
    (``TC_KERNELS``) has none of the instruction it must use.
    Without ``cuobjdump`` in the toolkit, print that it is not
    available."""
    import os
    import shutil

    tool = next((c for c in (shutil.which("cuobjdump"), os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"))
        if c and os.path.isfile(c)), None)
    if tool is None:
        print("[sass] HGMMA / HMMA counts: not available (no cuobjdump in "
              "the CUDA toolkit)")
        return
    counts, fn = {}, None
    for path in paths:
        sass = subprocess.run([tool, "--dump-sass", str(path)],
                              capture_output=True, text=True,
                              check=True).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                fn = f"{path.name} {line.split('Function :')[1].strip()}"
                counts[fn] = [0, 0]
            elif fn is not None:
                counts[fn][0] += "HGMMA" in line
                counts[fn][1] += "HMMA" in line
    for fn, (hg, hm) in counts.items():
        print(f"[sass] {fn}: {hg} HGMMA, {hm} HMMA")
    for k, inst in TC_KERNELS.items():
        tc = [c[0 if inst == "HGMMA" else 1] for fn, c in counts.items()
              if k in fn]
        if not tc or min(tc) == 0:
            fail(f"tensor-core kernel {k}: instantiations with no {inst} "
                 f"instruction, or none built ({tc})")


def stream_bound(name: str, R: int, k: int, jobs: int, carry_in: int,
                 carry_out: int, events: int, length: int = 0,
                 queued: int = 0) -> tuple[float, str]:
    """Least time for one carried chunk call: (ms, what bounds it).

    Bytes: the chunk's ``jobs`` records (over all lanes) read once, its
    outputs written once, of the carry the ``carry_in`` bytes the call
    needs read once and the ``carry_out`` bytes it gives back written
    once.  BS-π also reads the ``queued`` jobs' records (arrival, service,
    need: the ring they sit in is their class) and the horizon, and writes
    ``length`` event records a lane.  Operations: the per-event counts of
    :func:`bound` over the ``events`` the chunk's data holds (FCFS and
    ModBS-π one per job; BS-π the events its scan processed)."""
    log_k = max(1, (k - 1).bit_length())
    if name == "fcfs_stream_scan":
        nbytes, ops = jobs * (8 + 4 + 8 + 8), events * (3 + log_k)
    elif name == "modbs_stream_scan":
        nbytes = jobs * (8 + 4 + 4 + 8 + 1 + 8)
        ops = events * (6 + log_k)
    else:
        nbytes = (jobs * (8 + 4 + 4 + 8) + queued * (8 + 8 + 4)
                  + R * length * (4 + 8) + R * 8)
        ops = events * (8 + log_k)
    nbytes += carry_in + carry_out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def stream_path(dev, report: dict) -> None:
    """The stream path: each carried kernel against its plain version on
    the card after every chunk; ``simulate_stream`` replaying Fig. 1's
    batch at full width equal bit for bit to ``stream_fold(simulate)``,
    one launch per chunk; a generated 10^6-job BS-π stream at flat peak
    memory, checkpointed and resumed to the same bytes.  Adds the three
    stream entries to ``report``."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.bench import fm_cases, stream_cases as SC
    from repro_torch.core import engines, stream
    from repro_torch.core.workload import PoissonSource, figure1_workload
    from repro_torch.kernels.msj_scan import kernel as K

    t_phase = time.time()

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t1) * 1e3

    # -- kernel against plain version, chunk after chunk, on the card ------
    J, R, chunk = STREAM_CMP
    cuts = SC.bounds(J, chunk)
    cmp = {name: [] for name in STREAM_KERNELS}
    fm = [("fig1", fm_cases.fig1_case(2048, J, R, 1))]
    fm += [(n, fm_cases.ADVERSARIAL[n](J, R, 1)) for n in STREAM_FM_ADV]
    for label, case in fm:
        g = case.to(dev)
        runs = {
            "fcfs_stream_scan": lambda fn: SC.fcfs_chunks(fn, *g.fcfs, g.k,
                                                         cuts),
            "modbs_stream_scan": lambda fn: SC.modbs_chunks(
                fn, *g.modbs, g.slots, g.s_max, g.h, cuts)}
        for name, run in runs.items():
            kern, ms = timed(lambda: run(getattr(K, STREAM_KERNELS[name][0])))
            plain, plain_ms = timed(lambda: run(getattr(
                K, STREAM_KERNELS[name][0].replace("_fwd", "_ref"))))
            try:
                SC.equal_chunks(kern, plain, f"{name} {label}")
            except AssertionError as e:
                fail(str(e))
            extra = ""
            if name == "fcfs_stream_scan":
                extra = (f"; carried run-length groups up to "
                         f"{max(SC.groups_above(W, tp) for _, W, tp in plain)}")
            print(f"[stream] {name} {label} k={case.k} R={R} J={J} in "
                  f"chunks of {chunk}: outputs and canonical carry after "
                  f"every chunk equal at tolerance 0 (torch.equal) to the "
                  f"plain version on the card; {len(cuts)} chunks: kernel "
                  f"{ms:.1f} ms, plain {plain_ms:.1f} ms (host clock){extra}")
            cmp[name].append(dict(case=label, ms=ms / len(cuts),
                                  plain_ms=plain_ms / len(cuts)))
    for label in ("fig1",) + STREAM_BS_ADV:
        if label == "fig1":
            wl = figure1_workload(2048)
            b = wl.sample_traces(J, R, seed=1)
        else:
            b, wl = SC.bs_case_batch(label, J, R, 1)
        _, slots, s_max, h, q_cap, B = stream._bs_stream_args(
            None, wl, chunk, None, stream.BS_BACKLOG_CAP)
        run = lambda fn: SC.bs_chunks(fn, b, slots, s_max, h, q_cap, B, cuts,
                                      dev)
        kern, ms = timed(lambda: run(K.bs_stream_fwd))
        plain, plain_ms = timed(lambda: run(K.bs_stream_ref))
        try:
            SC.equal_chunks(kern, plain, f"bs_stream_scan {label}")
        except AssertionError as e:
            fail(str(e))
        backlog = max(int(c[-1]["pend_n"].max()) for c in plain[:-1])
        print(f"[stream] bs_stream_scan {label} k={wl.k} C={len(slots)} "
              f"s_max={s_max} h={h} R={R} J={J} in chunks of {chunk}, "
              f"backlog_cap={B}: event streams, carry and canonical state "
              f"after every chunk equal at tolerance 0 (torch.equal) to the "
              f"plain version on the card; backlog across a boundary up to "
              f"{backlog} jobs; {len(cuts)} chunks: kernel {ms:.1f} ms, "
              f"plain {plain_ms:.1f} ms (host clock)")
        cmp["bs_stream_scan"].append(dict(case=label, ms=ms / len(cuts),
                                          plain_ms=plain_ms / len(cuts)))

    # -- replay at full width: stream == fold(simulate), one launch a chunk
    wrappers = {pol: STREAM_KERNELS[name][0]
                for pol, name in zip(POLICIES, STREAM_KERNELS)}
    launches = {}
    for k in STREAM_KS:
        wl = figure1_workload(k)
        b = wl.sample_traces(STREAM_J, REPS, seed=0)
        for pol in POLICIES:
            fold = stream.stream_fold(engines.simulate(pol, b, wl=wl))
            for chunk_jobs in STREAM_CHUNKS:
                K.reset_launches()
                sr, ms = timed(lambda: engines.simulate_stream(
                    pol, b, chunk_jobs=chunk_jobs, wl=wl))
                counts = {w: n for w, n in K.launches().items() if n}
                want = {wrappers[pol]: -(-STREAM_J // chunk_jobs)}
                if counts != want:
                    fail(f"[stream] {pol} k={k} chunk {chunk_jobs} launched "
                         f"{counts}, expected {want}")
                for f in STREAM_FIELDS:
                    x, y = getattr(sr, f), getattr(fold, f)
                    if (x is None) != (y is None) or (
                            x is not None and x.tobytes() != y.tobytes()):
                        fail(f"[stream] {pol} k={k} chunk {chunk_jobs}: "
                             f"{f} differs from stream_fold(simulate)")
                if not np.isfinite(sr.mean_response).all():
                    fail(f"[stream] {pol} k={k}: non-finite mean response")
                rate = REPS * STREAM_J / (ms / 1e3)
                print(f"[stream] simulate_stream({pol}) Fig. 1 k={k} "
                      f"R={REPS} J={STREAM_J} chunk_jobs={chunk_jobs}: "
                      f"every StreamResult field equal bit for bit to "
                      f"stream_fold(simulate) on the card; launches "
                      f"{counts}; {ms / 1e3:.2f} s, {rate:.0f} jobs/s")
                if k == STREAM_KS[0] and chunk_jobs == STREAM_CHUNKS[0]:
                    launches[wrappers[pol]] = counts[wrappers[pol]]

    # -- a generated stream: flat peak memory, checkpoint and resume --------
    wl = figure1_workload(2048)
    ckpt = ROOT / "build" / "stream_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mem = {}
    for total in STREAM_GEN_TOTALS:
        src = PoissonSource(wl, reps=REPS, seed=7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        kw = dict(ckpt_dir=str(ckpt)) if total == STREAM_GEN_TOTALS[-1] else {}
        sr, ms = timed(lambda: engines.simulate_stream(
            "bs-fcfs", src, chunk_jobs=STREAM_CHUNKS[0], total_jobs=total,
            wl=wl, **kw))
        mem[total] = torch.cuda.max_memory_allocated()
        n = K.launches()["bs_stream_fwd"]
        print(f"[stream] simulate_stream(bs-fcfs, PoissonSource(Fig. 1 "
              f"k=2048), R={REPS}) after {total} jobs a replication"
              f"{' (checkpointed every chunk)' if kw else ''}: "
              f"{ms / 1e3:.2f} s, {REPS * total / (ms / 1e3):.0f} jobs/s, "
              f"{n} launches, torch.cuda.max_memory_allocated "
              f"{mem[total] / 2**20:.2f} MiB; mean response "
              f"{sr.mean_response.mean():.6f}, P[wait>0] "
              f"{sr.p_wait.mean():.6f}")
        if n != total // STREAM_CHUNKS[0]:
            fail(f"[stream] generated stream launched bs_stream_fwd {n} "
                 f"times, expected {total // STREAM_CHUNKS[0]}")
    small, big = (mem[t] for t in STREAM_GEN_TOTALS)
    print(f"[stream] peak memory after {STREAM_GEN_TOTALS[-1]} jobs / after "
          f"{STREAM_GEN_TOTALS[0]}: {big / small:.4f} (bound 1.05)")
    if big > 1.05 * small:
        fail(f"[stream] peak memory grew with the stream: {small} -> {big}")
    steps = sorted(p for p in ckpt.iterdir() if p.name.startswith("step_"))
    shutil.rmtree(steps[-1])
    res, ms = timed(lambda: engines.simulate_stream(
        "bs-fcfs", PoissonSource(wl, reps=REPS, seed=7),
        chunk_jobs=STREAM_CHUNKS[0], total_jobs=STREAM_GEN_TOTALS[-1], wl=wl,
        ckpt_dir=str(ckpt), resume=True))
    for f in STREAM_FIELDS:
        x, y = getattr(sr, f), getattr(res, f)
        if x.tobytes() != y.tobytes():
            fail(f"[stream] resumed stream: {f} differs from the run it "
                 f"resumed")
    print(f"[stream] deleted {steps[-1].name}, resumed from "
          f"{steps[-2].name} in {ms / 1e3:.2f} s: every StreamResult field "
          f"byte-identical to the uninterrupted run")
    shutil.rmtree(ckpt, ignore_errors=True)

    # -- device time of one chunk from a carried state, beside the bound --
    def chunk_call(name, k, R, Jc, seed):
        """(call, bound) of ``name``'s kernel on the second Jc-job chunk of
        a Fig. 1 trace at k, from the carry the first chunk gave out."""
        fc = fm_cases.fig1_case(k, 2 * Jc, R, seed).to(dev)
        first = SC.bounds(2 * Jc, Jc)[:1]
        if name == "fcfs_stream_scan":
            _, W, tp = SC.fcfs_chunks(K.fcfs_stream_fwd, *fc.fcfs, k,
                                      first)[0]
            args = tuple(x[:, Jc:].contiguous() for x in fc.fcfs)
            cb = (W.numel() + R) * 8
            return (lambda: K.fcfs_stream_fwd(*args, W, tp),
                    stream_bound(name, R, k, R * Jc, cb, cb, R * Jc))
        if name == "modbs_stream_scan":
            mb = SC.modbs_chunks(K.modbs_stream_fwd, *fc.modbs, fc.slots,
                                 fc.s_max, fc.h, first)[0]
            args = tuple(x[:, Jc:].contiguous() for x in fc.modbs)
            cb = sum(x.numel() * 8 for x in mb[2:])
            return (lambda: K.modbs_stream_fwd(*args, *mb[2:]),
                    stream_bound(name, R, k, R * Jc, cb, cb, R * Jc))
        # BS-π: the driver's own chunk step, its call captured, drained
        wl = figure1_workload(k)
        b = wl.sample_traces(2 * Jc, R, seed=seed)
        _, slots, s_max, h, q_cap, B = stream._bs_stream_args(
            None, wl, Jc, None, stream.BS_BACKLOG_CAP)
        canon = SC.bs_chunks(K.bs_stream_fwd, b, slots, s_max, h, q_cap, B,
                             first, dev)[0][-1]
        capture = stream._bs_device_scan(lambda *a, **kw: (a, kw), dev,
                                         slots, s_max, h, q_cap)
        (a, kw), _, _ = stream._bs_chunk_scan(
            canon, b.slice_jobs(Jc, 2 * Jc), Jc, np.full(R, np.inf), capture,
            slots, s_max, h, q_cap, B)
        dc, C = a[6], len(slots)
        # the kernel reads of the carried ring only the queued entries
        st = dc[1].long()
        queued = int((st[:, 2 * C:] - st[:, C:2 * C]).clamp(max=q_cap).sum())
        cb = sum(x.numel() * x.element_size() for x in dc)
        cb_in = cb - dc[3].numel() * dc[3].element_size() + queued * 4
        events = int(K.bs_stream_fwd(*a, **kw)[0][9].sum())
        return (lambda: K.bs_stream_fwd(*a, **kw),
                stream_bound(name, R, k, R * Jc, cb_in, cb, events,
                             kw["length"], queued))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for name, (wrapper, replaces) in STREAM_KERNELS.items():
        call, (b_ms, b_by) = chunk_call(name, 2048, R, chunk, 1)
        ms = cuda_ms(call, 5)
        main, (mb_ms, mb_by) = chunk_call(name, STREAM_KS[0], REPS,
                                          STREAM_CHUNKS[0], 0)
        main_ms = cuda_ms(main, 3)
        plain_ms = cmp[name][0]["plain_ms"]
        print(f"[time] {name} Fig. 1 k=2048, one chunk from a carried "
              f"state: R={R} chunk {chunk}: {ms:.3f} ms (plain version "
              f"{plain_ms:.1f} ms, host clock), bound {b_ms:.5f} ms "
              f"({b_by}); R={REPS} chunk {STREAM_CHUNKS[0]}: {main_ms:.3f} "
              f"ms, bound {mb_ms:.5f} ms ({mb_by}); {smi}")
        report[name] = dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[wrapper],
            max_abs_err=0.0,   # every compared tensor was torch.equal
            ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"Fig. 1 k=2048 R={R}, a {chunk}-job chunk from a carried "
                  f"state",
            main_ms=main_ms, main_bound_ms=mb_ms,
            main_shape=f"Fig. 1 k={STREAM_KS[0]} R={REPS}, a "
                       f"{STREAM_CHUNKS[0]}-job chunk from a carried state",
            comparisons=cmp[name])
    print(f"[stream] the stream phase took {time.time() - t_phase:.1f} s")


def paper_path(dev, report: dict) -> None:
    """Phase 3e, the paper's policy set: the port's event engine
    (``engine="python"``, host code that shares nothing with the kernels
    or their plain versions) as the kernels' oracle, and Fig. 3 on the
    paper's six policies at full width.  Adds this path's launches to the
    ``report`` entries of the kernels it runs."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.bench import bs_cases, fig3_traces
    from repro_torch.core import engines
    from repro_torch.core.workload import (BatchTrace, figure1_workload,
                                           sdsc_sp2_workload)
    from repro_torch.data.swf import sdsc_sp2_trace
    from repro_torch.kernels.msj_scan import kernel as K

    t_phase = time.time()
    scan = fig3_traces.SCAN_POLICIES

    # -- registry parity on the card: each kernel == the event engine ----
    wl1 = figure1_workload(256)
    wl3 = sdsc_sp2_workload(k=512, load=0.85)
    b3 = BatchTrace.from_trace(sdsc_sp2_trace(1000, k=512, load=0.85,
                                              seed=5), 2, seed=5)
    bd = wl1.sample_traces(1000, 2, seed=6)
    cases = [("Fig. 1 k=256 J=2000 R=2", wl1.sample_traces(2000, 2, seed=4),
              wl1, None, scan),
             ("SDSC-SP2 bootstrap k=512 load=0.85 J=1000 R=2", b3, wl3,
              None, scan),
             ("Fig. 1 k=256 J=1000 R=2 bench outages (drain)", bd, wl1,
              bs_cases.bench_failures(wl1, bd, seed=6), POLICIES)]
    for what, b, wl, fb, pols in cases:
        for pol in pols:
            t1 = time.time()
            on_card = engines.simulate(pol, b, wl=wl, failures=fb,
                                       device=dev)
            torch.cuda.synchronize()
            t2 = time.time()
            oracle = engines.simulate(pol, b, wl=wl, failures=fb,
                                      engine="python")
            t3 = time.time()
            for fld in dataclasses.fields(oracle):
                x, y = getattr(on_card, fld.name), getattr(oracle, fld.name)
                if (x is None) != (y is None) or (
                        x is not None and not (x.dtype == y.dtype
                                               and np.array_equal(x, y))):
                    fail(f"[paper] {pol} on {what}: {fld.name} of the "
                         f"kernel differs from engine='python'")
            print(f"[paper] {pol:>10} {what}: kernel == engine='python' "
                  f"on every BatchSimResult field at tolerance 0 (card "
                  f"{t2 - t1:.2f} s, event engine {t3 - t2:.2f} s)")

    # -- the paper's six policies at full width (the first run of this
    # process to send serverfilling / msf to the event engine, so the one
    # fallback warning of each comes here) ---------------------------------
    K.reset_launches()
    t1 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows = fig3_traces.run(ks=(1024,), loads=(0.85,), reps=2,
                               device=dev)
    torch.cuda.synchronize()
    counts = K.launches()
    wall = time.time() - t1
    fell = sorted(str(w.message).split("'")[1] for w in caught
                  if "falling back" in str(w.message))
    print(f"[paper] fig3_traces.run(ks=(1024,), loads=(0.85,), reps=2) "
          f"(2 datasets x the paper's 6 policies, J={FIG3_J}): {wall:.1f} "
          f"s, launches {counts}; fallback warnings for {fell}")
    grid_launches("paper", counts, {"fcfs_scan_fwd": 1, "bs_scan_fwd": 1,
                                    "srpt_scan_fwd": 2})
    if fell != ["msf", "serverfilling"]:
        fail(f"[paper] expected one fallback warning each for msf and "
             f"serverfilling, got {fell}")
    if len(rows) != 12:
        fail(f"[paper] {len(rows)} rows, expected 12")
    by_engine = {"torch": 0.0, "python": 0.0}
    for r in rows:
        want = "python" if r["policy"] in ("serverfilling", "msf") else \
            "torch"
        if r["engine"] != want:
            fail(f"[paper] {r['policy']} ran on {r['engine']}, expected "
                 f"{want}")
        by_engine[r["engine"]] += r["sim_s"]
        finite = all(np.isfinite(r[f]) for f in ("mean_response", "p_wait",
                                                 "p95_response"))
        if not finite and not (r["mean_response"] == float("inf")
                               and r.get("note")):
            fail(f"[paper] non-finite row without a note: {r}")
        note = f" note={r['note']}" if r.get("note") else ""
        print(f"[paper] {r['dataset']} k={r['k']} load={r['load']} "
              f"{r['policy']:>13} engine={r['engine']:<6} mean_response="
              f"{r['mean_response']:.6f} p_wait={r['p_wait']:.6f} "
              f"p95={r['p95_response']:.6f} util={r['utilization']:.6f} "
              f"sim_s={r['sim_s']}{note}")
    print(f"[paper] sim_s summed: kernel rows {by_engine['torch']:.2f} s, "
          f"event-engine rows {by_engine['python']:.2f} s")

    # -- Fig. 3 rows do not depend on the engine -------------------------
    small = dict(num_jobs=800, ks=(256,), loads=(0.7,), reps=2)
    t1 = time.time()
    py_rows = fig3_traces.run(engine="python", **small)
    t2 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        card_rows = fig3_traces.run(device=dev, **small)
    t3 = time.time()
    strip = lambda rows: [{c: v for c, v in r.items()
                           if c not in ("sim_s", "engine")} for r in rows]
    if len(py_rows) != 12 or strip(py_rows) != strip(card_rows):
        fail("[paper] Fig. 3 rows on engine='python' differ from the rows "
             "on the card")
    print(f"[paper] fig3_traces.run(J=800, k=256, load=0.7, R=2): "
          f"engine='python' rows == the card's rows on every column but "
          f"sim_s and engine ({len(py_rows)} rows; python {t2 - t1:.2f} s, "
          f"card {t3 - t2:.2f} s)")
    for name, wrapper in (("fcfs_scan", "fcfs_scan_fwd"),
                          ("bs_scan", "bs_scan_fwd"),
                          ("srpt_scan", "srpt_scan_fwd")):
        report[name]["paper_launches"] = counts[wrapper]
        report[name]["launches"] += counts[wrapper]
    print(f"[paper] the paper-policy phase took {time.time() - t_phase:.1f} "
          f"s")


def loss_bound(R: int, J: int) -> tuple[float, str]:
    """Least time for one ``loss_scan`` call: (ms, what bounds it).

    Bytes: arrival and service read once (8 + 8 bytes a job), the blocked
    flag written once (1 byte).  Operations: one compare and one add a
    job, far below the bytes' time.
    """
    t_bytes = R * J * 17 / HBM_BYTES_PER_S
    t_ops = R * J * 2 / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def theory_path(dev, report: dict, sw) -> None:
    """Phase 3f, the theory path: ``loss_scan`` against its plain version
    and the heapq oracle; then, with the counts set to 0 just before and
    read just after, Property 1 at full width (``modbs_scan``'s blocked
    mask of each class == ``loss_scan`` on the class's substream, P_H
    within 0.01 of eq. (16)), Fig. 2's two sweeps through
    ``bench/fig2_regimes``, ``bench/theory_tables.run`` and
    ``fig3_traces.run_swf``; each driver card == CPU at small size; the
    Fig. 1 rows of phase 3's sweep with ``bench/fig1_critical``'s theory
    columns; ``[time] loss_scan``.  Adds ``loss_scan`` to ``report`` and
    this path's launches to the entries of the kernels it runs."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.bench import (fig1_critical, fig2_regimes, fig3_traces,
                                   loss_cases, theory_tables)
    from repro_torch.core import erlang, sim_batch, theory
    from repro_torch.core.partition import balanced_partition
    from repro_torch.core.workload import figure1_workload
    from repro_torch.data import swf
    from repro_torch.kernels.msj_scan import kernel as K

    t_phase = time.time()
    strip = lambda rows: [{c: v for c, v in r.items() if c != "sim_s"}
                          for r in rows]

    # -- loss_scan against its plain version on the card ------------------
    R, J = LOSS_CMP
    cases = [(f"M/M/s/s s={s} load 1.1 s", s,
              loss_cases.mmss_case(R, J, 1.1 * s, seed=s))
             for s in LOSS_SS + (K.LOSS_S_MAX,)]
    cases.append(("equal arrival times s=6", 6, loss_cases.ties_case(R, J)))
    plain_ms = None
    for what, s, (arrival, service) in cases:
        a, v = (torch.tensor(x, device=dev) for x in (arrival, service))
        out = K.loss_scan_fwd(a, v, s=s)
        torch.cuda.synchronize()
        t1 = time.time()
        ref_dev = K.loss_scan_ref(a, v, s=s)
        torch.cuda.synchronize()
        ms_plain = (time.time() - t1) * 1e3
        ref_cpu = K.loss_scan_ref(a.cpu(), v.cpu(), s=s)
        if not (torch.equal(out, ref_dev) and torch.equal(out.cpu(),
                                                          ref_cpu)):
            fail(f"[theory] loss_scan on {what} (R={R} J={J}) differs from "
                 f"its plain version")
        if s == 6 and plain_ms is None:
            plain_ms, (a6, v6) = ms_plain, (a, v)
        print(f"[theory] loss_scan {what} R={R} J={J}: equal at tolerance "
              f"0 (torch.equal) to the plain version on the card and on "
              f"the CPU; blocked {out.float().mean().item():.6f}; plain on "
              f"card {ms_plain:.1f} ms")
    ms_cmp = cuda_ms(lambda: K.loss_scan_fwd(a6, v6, s=6), 5)
    b_cmp, b_cmp_by = loss_bound(R, J)

    # -- loss_scan against the heapq oracle at full width -----------------
    R2, J2, s2, lam2 = LOSS_MMSS
    arrival, service = loss_cases.mmss_case(R2, J2, lam2, seed=3)
    out = K.loss_scan_fwd(torch.tensor(arrival, device=dev),
                          torch.tensor(service, device=dev), s=s2).cpu()
    t1 = time.time()
    for r in range(R2):
        if not np.array_equal(out[r].numpy(), loss_cases.loss_oracle(
                arrival[r], service[r], s2)):
            fail(f"[theory] loss_scan replication {r} differs from the "
                 f"heapq oracle (M/M/s/s s={s2} lam={lam2} J={J2})")
    e_b = erlang.erlang_b(s2, lam2)
    pb = out.float().mean().item()
    print(f"[theory] loss_scan M/M/s/s s={s2} lambda={lam2} d=1 R={R2} "
          f"J={J2}: equal to the heapq oracle in every replication (oracle "
          f"{time.time() - t1:.1f} s); blocking {pb:.6f}, Erlang-B "
          f"E_{s2}({lam2:g}) {e_b:.6f}, |diff| {abs(pb - e_b):.6f} (limit "
          f"0.01)")
    if abs(pb - e_b) > 0.01:
        fail(f"[theory] M/M/s/s blocking {pb} is not within 0.01 of "
             f"Erlang-B {e_b}")

    # -- the theory path, counts from 0 -----------------------------------
    K.reset_launches()
    t_main = time.time()
    kp = PROP1_K
    wl = figure1_workload(kp)
    b = wl.sample_traces(MAIN_J, REPS, seed=11)
    slots = balanced_partition(wl).slots
    blocked = sim_batch.modified_bs_sim_batch(b, wl=wl, device=dev).blocked
    bad = loss_cases.property1_mismatches(
        b, blocked, slots, lambda a, v, s: sim_batch.loss_queue_sim_batch(
            a, v, s, device=dev).blocked)
    if bad:
        fail(f"[theory] Property 1 fails at Fig. 1 k={kp} for (class, "
             f"replication) {bad[:8]}")
    ph, bound16 = blocked.mean(), theory.p_helper_upper_bound(wl)
    print(f"[theory] Property 1 at Fig. 1 k={kp} J={MAIN_J} R={REPS}: "
          f"modbs_scan's blocked mask of each class == loss_scan with "
          f"slots[c] on that class's substream (slots {slots}); P_H "
          f"{ph:.6f}, eq. (16) {bound16:.6f}, |diff| {abs(ph - bound16):.6f} "
          f"(limit 0.01)")
    if abs(ph - bound16) > 0.01:
        fail(f"[theory] P_H {ph} is not within 0.01 of eq. (16) {bound16}")

    t1 = time.time()
    heavy = fig2_regimes.run_heavy_scan(device=dev)
    sub = fig2_regimes.run_subcritical_scan(device=dev)
    torch.cuda.synchronize()
    wall2 = time.time() - t1
    print(f"[theory] Fig. 2 through bench/fig2_regimes at the defaults' "
          f"cells (heavy: k=512, loads 0.5-0.95; subcritical: load 0.85, "
          f"k 256-2048; J=100000, R=8, not cut) on the card: "
          f"{wall2:.1f} s, {len(heavy)} + {len(sub)} rows")
    for r in heavy + sub:
        print(f"[theory] fig2 {r['regime']} k={r['k']} load={r['load']} "
              f"{r['policy']:>10}: mean_response={r['mean_response']:.6f} "
              f"p_wait={r['p_wait']:.6f} p_helper={r['p_helper']} "
              f"sim_s={r['sim_s']}")
        for f in ("mean_response", "p_wait", "p95_response", "utilization"):
            if not np.isfinite(r[f]):
                fail(f"[theory] non-finite {f} in Fig. 2 row {r}")
    if len(heavy) != 15 or len(sub) != 12:
        fail(f"[theory] Fig. 2 gave {len(heavy)} + {len(sub)} rows, "
             f"expected 15 + 12")

    t1 = time.time()
    tables = theory_tables.run(mc_jobs=TABLES_MC_JOBS, device=dev)
    print(f"[theory] theory_tables.run(mc_jobs={TABLES_MC_JOBS}, the "
          f"default, not cut) on the card: {time.time() - t1:.1f} s")
    for r in tables:
        print(f"[theory] {r['table']} k={r['k']} f_k={r['f_k']} value="
              f"{r['value']:.6g} reference={r['reference']:.6g} mc="
              f"{r['mc']}")
        if r["mc"] is not None and not np.isfinite(r["mc"]):
            fail(f"[theory] non-finite mc in {r}")

    logdir = ROOT / "build" / "theory_swf"
    shutil.rmtree(logdir, ignore_errors=True)
    logdir.mkdir(parents=True)
    log = str(logdir / "sdsc_sp2.swf")
    swf.write_swf(swf.sdsc_sp2_trace(FIG3_J, k=512, load=0.85, seed=2), log)
    t1 = time.time()
    swf_rows = fig3_traces.run_swf(log, k=512, policies=fig3_traces.
                                   SCAN_POLICIES, device=dev)
    torch.cuda.synchronize()
    print(f"[theory] run_swf on an SDSC-SP2 log write_swf wrote (J="
          f"{FIG3_J}, k=512, R=4, moving-block bootstrap, the 5 scan "
          f"policies): {time.time() - t1:.1f} s")
    for r in swf_rows:
        print(f"[theory] swf {r['policy']:>10}: mean_response="
              f"{r['mean_response']:.6f} p_wait={r['p_wait']:.6f} "
              f"sim_s={r['sim_s']}")
        if not np.isfinite(r["mean_response"]):
            fail(f"[theory] non-finite run_swf row {r}")
    counts = K.launches()
    wall = time.time() - t_main
    want = {"loss_scan_fwd": len([c for c in slots if c]),
            "modbs_scan_fwd": 1 + 2 + 5 + 1, "fcfs_scan_fwd": 2 + 1,
            "bs_scan_fwd": 2 + 1, "srpt_scan_fwd": 2}
    got = {w: n for w, n in counts.items() if n}
    print(f"[theory] the path (Property 1, Fig. 2, theory tables, run_swf) "
          f"on the card: {wall:.1f} s, launches {got} (expected {want})")
    if got != want:
        fail(f"[theory] the theory path launched {got}, expected {want}")

    # -- Fig. 1 rows with the theory columns, from phase 3's sweep --------
    rows1 = sw.rows("k", per_point_cols=[fig1_critical._theory_cols(k, 0.7)
                                         for k in MAIN_KS])
    for r in rows1:
        print(f"[theory] fig1 k={r['k']} {r['policy']:>10}: p_helper="
              f"{r['p_helper']} ph_bound={r['ph_bound']:.6f} zero_wait_R="
              f"{r['zero_wait_R']:.6f} mean_response="
              f"{r['mean_response']:.6f}")
        if r["policy"] == "modbs-fcfs" and abs(r["p_helper"]
                                               - r["ph_bound"]) > 0.01:
            fail(f"[theory] Fig. 1 k={r['k']}: ModBS-pi's P_H "
                 f"{r['p_helper']} is not within 0.01 of eq. (16)")

    # -- each driver card == CPU at small size ----------------------------
    small = dict(num_jobs=1000, reps=2)
    pairs = [
        ("fig1_critical.run_scan(ks=(256,), J=1000, R=2)", lambda d:
         fig1_critical.run_scan(ks=(256,), device=d, **small)),
        ("fig2_regimes.run_heavy_scan(loads=(0.5, 0.95), J=1000, R=2)",
         lambda d: fig2_regimes.run_heavy_scan(loads=(0.5, 0.95), device=d,
                                               **small)),
        ("fig2_regimes.run_subcritical_scan(ks=(256, 2048), J=1000, R=2)",
         lambda d: fig2_regimes.run_subcritical_scan(ks=(256, 2048),
                                                     device=d, **small)),
        ("theory_tables.run(mc_jobs=1000)", lambda d: theory_tables.run(
            mc_jobs=1000, device=d)),
        ("fig3_traces.run_swf(k=512, jobs=400, reps=2)", lambda d:
         fig3_traces.run_swf(log, k=512, jobs=400, reps=2,
                             policies=fig3_traces.SCAN_POLICIES, device=d))]
    for what, run in pairs:
        t1 = time.time()
        card = run(dev)
        t2 = time.time()
        cpu = run("cpu")
        if strip(card) != strip(cpu):
            fail(f"[theory] {what}: the card's rows differ from the CPU's")
        print(f"[theory] {what}: card == CPU on every column but sim_s "
              f"({len(card)} rows; card {t2 - t1:.2f} s, CPU "
              f"{time.time() - t2:.2f} s)")
    shutil.rmtree(logdir, ignore_errors=True)

    # -- [time] loss_scan at full width -----------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    main_ms = {}
    for s in LOSS_TIME_SS:
        arrival, service = loss_cases.mmss_case(REPS, MAIN_J, 0.8 * s,
                                                seed=s)
        a, v = (torch.tensor(x, device=dev) for x in (arrival, service))
        main_ms[s] = ms = cuda_ms(lambda: K.loss_scan_fwd(a, v, s=s), 3)
        b_ms, b_by = loss_bound(REPS, MAIN_J)
        print(f"[time] loss_scan s={s} offered load 0.8 s R={REPS} "
              f"J={MAIN_J}: {ms:.3f} ms per launch ({ms * 1e3 / MAIN_J:.4f} "
              f"us per step), bound {b_ms:.5f} ms ({b_by}: R J 17 bytes at "
              f"3.35 TB/s), launches on the theory path "
              f"{counts['loss_scan_fwd']}; {smi}")
    report["loss_scan"] = dict(
        name="loss_scan", route="cuda", source=SOURCE,
        replaces="src/repro/core/sim_jax.py:105",
        launches=counts["loss_scan_fwd"], max_abs_err=0.0,  # torch.equal
        ms=ms_cmp, plain_ms=plain_ms, bound_ms=b_cmp, bound_by=b_cmp_by,
        library_ms=None, shape=f"M/M/s/s s=6 R={R} J={J}",
        main_ms_s10=main_ms[LOSS_TIME_SS[0]],
        main_ms_s196=main_ms[LOSS_TIME_SS[1]],
        main_bound_ms=loss_bound(REPS, MAIN_J)[0],
        main_shape=f"M/M/s/s offered load 0.8 s R={REPS} J={MAIN_J}")
    for name, wrapper in (("fcfs_scan", "fcfs_scan_fwd"),
                          ("modbs_scan", "modbs_scan_fwd"),
                          ("bs_scan", "bs_scan_fwd"),
                          ("srpt_scan", "srpt_scan_fwd")):
        report[name]["theory_launches"] = counts[wrapper]
        report[name]["launches"] += counts[wrapper]
    print(f"[theory] the theory phase took {time.time() - t_phase:.1f} s")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, queued behind a
    sleep kernel: :func:`repro_torch.bench.timing.device_ms`."""
    from repro_torch.bench.timing import device_ms

    return device_ms(fn, reps)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from repro_torch.bench import bs_cases, fig3_traces, fm_cases, srpt_cases
    from repro_torch.core import engines, sim_torch
    from repro_torch.core.sim_batch import (_bs_fail_args,
                                            _merged_class_inputs,
                                            _merged_fcfs_inputs,
                                            _merged_tensors,
                                            sweep_many_server)
    from repro_torch.core.workload import SDSC_SP2_TABLE, figure1_workload
    from repro_torch.kernels.msj_scan import build
    from repro_torch.kernels.msj_scan import kernel as K

    dev = torch.device("cuda", 0)
    t_start = time.time()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build: both libraries at once, each source in its own nvcc ----
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import attention_build
    from repro_torch.kernels.mamba_scan import build as mamba_build
    from repro_torch.kernels.moe_gmm import build as gmm_build
    from repro_torch.kernels.rwkv6 import build as wkv_build

    t0 = time.time()
    libs = (build.LIBRARY, attention_build.LIBRARY, gmm_build.LIBRARY,
            wkv_build.LIBRARY, mamba_build.LIBRARY)
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libs))
    for lib, lib_path in zip(libs, paths):
        lib.load()
        print(f"[build] {lib_path.relative_to(ROOT)} (built with the other "
              f"libraries; all in {time.time() - t0:.1f} s)")
        for line in (lib_path.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")
    tensor_core_instructions(paths)

    def inputs(k: int, J: int, seed: int):
        wl = figure1_workload(k)
        b = wl.sample_traces(J, REPS, seed=seed)
        slots, s_max, h, q_cap = sim_torch._bs_args(
            b, None, wl, min(MAIN_J, 8192))
        t = dict(arrival=torch.tensor(b.arrival, device=dev),
                 cls=torch.tensor(b.cls, dtype=torch.int32, device=dev),
                 need=torch.tensor(b.need, dtype=torch.int32, device=dev),
                 service=torch.tensor(b.service, device=dev),
                 slots=torch.tensor(slots, device=dev))
        return t, dict(k=k, s_max=s_max, h=h, q_cap=q_cap)

    def calls(t, p):
        """name -> (kernel call, plain call) on the same tensors."""
        a, c, n, v, sl = (t["arrival"], t["cls"], t["need"], t["service"],
                          t["slots"])
        kw_m = dict(s_max=p["s_max"], h=p["h"])
        kw_b = dict(kw_m, q_cap=p["q_cap"])
        return {
            "fcfs_scan": (lambda: K.fcfs_scan_fwd(a, n, v, k=p["k"]),
                          lambda x: K.fcfs_scan_ref(*x(a, n, v), k=p["k"])),
            "modbs_scan": (lambda: K.modbs_scan_fwd(a, c, n, v, sl, **kw_m),
                           lambda x: K.modbs_scan_ref(*x(a, c, n, v, sl),
                                                      **kw_m)),
            "bs_scan": (lambda: K.bs_scan_fwd(a, c, n, v, sl, **kw_b),
                        lambda x: K.bs_scan_ref(*x(a, c, n, v, sl), **kw_b)),
        }

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def max_err(out, ref):
        """Largest |kernel - plain| over the outputs; equal entries count
        0, so equal infinities do not give nan."""
        err = 0.0
        for o, r in zip(out, ref):
            o, r = o.double(), r.double().to(dev)
            d = torch.where(o == r, 0.0, (o - r).abs())
            err = max(err, d.max().item())
        return err

    # -- 2. kernels against their plain versions --------------------------
    report = {}
    for k in (256, 2048):
        t, p = inputs(k, CMP_J, seed=1)
        for name, (kern, plain) in calls(t, p).items():
            out = as_tuple(kern())
            torch.cuda.synchronize()
            ref_cpu = as_tuple(plain(lambda *x: [y.cpu() for y in x]))
            t1 = time.time()
            ref_dev = as_tuple(plain(lambda *x: x))
            torch.cuda.synchronize()
            plain_ms = (time.time() - t1) * 1e3
            for o, r_cpu, r_dev in zip(out, ref_cpu, ref_dev):
                if not (torch.equal(o.cpu(), r_cpu)
                        and torch.equal(o, r_dev)):
                    fail(f"{name} at k={k} J={CMP_J} R={REPS} differs from "
                         f"its plain version")
            err = max((o.double() - r.double().to(dev)).abs().max().item()
                      for o, r in zip(out, ref_cpu))
            ms = cuda_ms(kern, 3)
            b_ms, b_by = bound(name, REPS, CMP_J, k)
            print(f"[kernel] {name} k={k} C={t['slots'].numel()} "
                  f"s_max={p['s_max']} h={p['h']} q_cap={p['q_cap']} "
                  f"R={REPS} J={CMP_J} (J cut: the plain version is a "
                  f"Python event loop): equal at tolerance 0 (torch.equal) "
                  f"to the plain version on CPU and on card, kernel {ms:.3f} ms, plain on card "
                  f"{plain_ms:.1f} ms, bound {b_ms:.5f} ms ({b_by})")
            report[name] = dict(
                name=name, route="cuda", source=SOURCE,
                replaces=KERNELS[name][1], launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"k={k} R={REPS} J={CMP_J}")


    # -- 2b. srpt_scan and stable_sort against their plain versions --------
    NU = tuple(sorted(int(row[2]) for row in SDSC_SP2_TABLE))

    def srpt_inputs(k: int, J: int, seed: int, dataset: str = "sdsc"):
        """R IID bootstraps of a Table-2 (SDSC-SP2) or Table-3 (KIT-FH2)
        trace at load 0.85, on the card, and the slot-table width of the
        Fig. 3 path's J = 15 000 cells."""
        t, _ = srpt_cases.table_case(dataset, J, k, FIG3_R, seed=seed,
                                     device=dev)
        return t, srpt_cases.slots(FIG3_J, k)

    def srpt_case(label: str, t, NU: tuple, Q: int, J: int, k: int,
                  ovf: bool, card_plain: bool = True):
        """srpt_scan SF and FF on the card against the plain version on the
        CPU and (``card_plain``) on the card, all 7 outputs at tolerance 0
        (torch.equal); ``ovf``: whether every replication must overflow its
        Q slots."""
        R_ = t[0].shape[0]
        for sf in (True, False):
            kw = dict(Q=Q, NU=NU, sf=sf)
            out = K.srpt_scan_fwd(*t, **kw)
            torch.cuda.synchronize()
            t1 = time.time()
            ref_cpu = K.srpt_scan_fwd(*(x.cpu() for x in t), **kw)
            plain_ms = (time.time() - t1) * 1e3
            where = "CPU"
            ref_dev = ref_cpu
            if card_plain:
                t1 = time.time()
                ref_dev = K.srpt_scan_ref(*t, **kw)
                torch.cuda.synchronize()
                plain_ms = (time.time() - t1) * 1e3
                where = "card"
            for o, r_cpu, r_dev in zip(out, ref_cpu, ref_dev):
                if not (torch.equal(o.cpu(), r_cpu)
                        and torch.equal(o.cpu(), r_dev.cpu())):
                    fail(f"srpt_scan {label} sf={sf} at k={k} Q={Q} J={J} "
                         f"differs from its plain version")
            if ovf:
                if not out[3].all():
                    fail(f"srpt_scan {label} sf={sf} Q={Q}: no overflow")
            elif out[3].any() or not (out[5] == 2 * J).all():
                fail(f"srpt_scan {label} sf={sf} k={k}: overflow or missing "
                     f"events")
            ms = cuda_ms(lambda: K.srpt_scan_fwd(*t, **kw), 3)
            pol = "sf" if sf else "ff"
            cfg = dict(case=label, policy=pol, k=k, Q=Q, J=J, ms=ms,
                       plain_ms=plain_ms, err=max_err(out, ref_cpu))
            if ovf:
                # dropped arrivals never depart: n and the bound, both read
                # off the departure stream, do not apply
                cfg.update(bound_ms=None, bound_by=None, n_mean=None,
                           n_max=None)
                n_txt = "arrivals dropped (n and bound not read)"
            else:
                b_ms, b_by = srpt_bound(R_, J, out[0].cpu().numpy())
                n = srpt_cases.jobs_in_system(out[0].cpu().numpy())
                cfg.update(bound_ms=b_ms, bound_by=b_by,
                           n_mean=float(n.mean()), n_max=int(n.max()))
                n_txt = (f"bound {b_ms:.5f} ms ({b_by}); jobs in system "
                         f"per event mean {n.mean():.1f} max {n.max()}")
            print(f"[kernel] srpt_scan {label} {pol} k={k} Q={Q} NU={NU} "
                  f"R={R_} J={J}: all 7 outputs equal at tolerance 0 "
                  f"(torch.equal) to the plain version on CPU"
                  f"{' and on card' if card_plain else ''}, kernel "
                  f"{ms:.3f} ms ({ms * 1e3 / (2 * J):.3f} us per event), "
                  f"plain on {where} {plain_ms:.1f} ms, "
                  f"{n_txt}, peak {out[6].tolist()}, preemptions "
                  f"{out[4].tolist()}")
            srpt_cfgs.append(cfg)

    # the Fig. 3 path's widths (J cut: the plain version is a Python event
    # loop); KIT-FH2's 78 % need-1 mix; a burst of equal arrival times with
    # n in the hundreds to over a thousand; a table that overflows
    srpt_cfgs = []
    for k in FIG3_KS:
        t, Q = srpt_inputs(k, SRPT_CMP_J, seed=1)
        srpt_case("sdsc", t, NU, Q, SRPT_CMP_J, k, ovf=False)
    t, Q = srpt_inputs(1024, SRPT_KIT_J, seed=1, dataset="kit")
    srpt_case("kit", t, NU, Q, SRPT_KIT_J, 1024, ovf=False)
    t, NU_b = srpt_cases.burst_case(SRPT_BURST_CMP_J, 512, FIG3_R,
                                    batch=100, gap=0.5, seed=1, device=dev)
    srpt_case("burst", t, NU_b, 2048, SRPT_BURST_CMP_J, 512, ovf=False)
    t, _ = srpt_inputs(512, SRPT_OVF_J, seed=1)
    srpt_case("overflow", t, NU, 4, SRPT_OVF_J, 512, ovf=True)
    # Q = 8192: the slot table outgrows shared memory and lives in global
    # scratch; SDSC-SP2 at k = 2048, and one batch of equal arrivals that
    # puts more than 4096 jobs in the system at once
    t, _ = srpt_cases.table_case("sdsc", SRPT_Q8K_J, 2048, FIG3_R, seed=1,
                                 device=dev)
    srpt_case("sdsc", t, NU, 8192, SRPT_Q8K_J, 2048, ovf=False)
    t, NU_w = srpt_cases.burst_case(SRPT_WIDE_J, SRPT_WIDE_J, 1,
                                    batch=SRPT_WIDE_J, gap=1.0, seed=1,
                                    device=dev)
    srpt_case("wide burst", t, NU_w, 8192, SRPT_WIDE_J, SRPT_WIDE_J,
              ovf=False, card_plain=False)
    if srpt_cfgs[-1]["n_max"] <= 4096:
        fail(f"the wide burst kept {srpt_cfgs[-1]['n_max']} jobs in the "
             f"system, expected more than 4096")
    top = srpt_cfgs[2]           # k = 1024, SDSC, SF: the Fig. 3 width
    report["srpt_scan"] = dict(
        name="srpt_scan", route="cuda", source=SRPT_SOURCE,
        replaces=SRPT_REPLACES, launches=None,
        max_abs_err=max(c["err"] for c in srpt_cfgs), ms=top["ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None,
        shape=f"sf k=1024 Q={top['Q']} R={FIG3_R} J={SRPT_CMP_J}",
        configs=srpt_cfgs)

    rng = np.random.default_rng(7)

    def sort_inputs(W: int, num_keys: int):
        """Keys with many duplicates and +-inf; row 0 all equal, row 1
        all +inf; an int32 payload that numbers the entries."""
        k1 = rng.choice([-np.inf, np.inf, 0.0, 1.0, 1.5, 2.5], (SORT_R, W))
        k1[0], k1[1] = 0.5, np.inf
        k2 = rng.choice([0.0, 1.0, 4.0], (SORT_R, W))
        pay = np.arange(SORT_R * W, dtype=np.int32).reshape(SORT_R, W)
        keys = [torch.tensor(k1, device=dev), torch.tensor(k2, device=dev)]
        return keys[:num_keys] + [torch.tensor(pay, device=dev)]

    sort_errs = []
    for W in SORT_WS:
        for nk in (1, 2):
            ops = sort_inputs(W, nk)
            out = K.stable_sort_fwd(*ops, num_keys=nk)
            torch.cuda.synchronize()
            ref_cpu = K.stable_sort_fwd(*(x.cpu() for x in ops), num_keys=nk)
            t1 = time.time()
            ref_dev = K.stable_sort_ref(*ops, num_keys=nk)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t1) * 1e3
            for o, r_cpu, r_dev in zip(out, ref_cpu, ref_dev):
                if not (torch.equal(o.cpu(), r_cpu)
                        and torch.equal(o, r_dev)):
                    fail(f"stable_sort W={W} keys={nk} differs from its "
                         f"plain version")
            sort_errs.append(max_err(out, ref_cpu))
            ms = cuda_ms(lambda: K.stable_sort_fwd(*ops, num_keys=nk), 3)
            b_ms, b_by = sort_bound(SORT_R, W, nk)
            print(f"[kernel] stable_sort R={SORT_R} W={W} keys={nk}: equal "
                  f"at tolerance 0 (torch.equal) to the plain version on "
                  f"CPU and on card, kernel {ms:.4f} ms, plain on card "
                  f"{plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by})")

    # -- 2c. the drain-mode kernels against their plain versions ---------
    # bench_sim.bench_failures' outage process (mix "bench": mtbf = h/4,
    # mttr = h/400 per server over the arrival horizon h) and the "heavy"
    # mix (mttr = h/40 on pods of 4 servers)
    bench_failures = bs_cases.bench_failures

    def fail_inputs(k: int, J: int, mix: str, seed: int):
        """The three fail kernels' inputs on the card (BS-π's rings hold
        q_cap = J, so none can overflow) and this data's event counts."""
        wl = figure1_workload(k)
        b = wl.sample_traces(J, REPS, seed=seed)
        fb = bench_failures(wl, b, mix, seed=seed)
        slots, s_max, h, q_cap = sim_torch._bs_args(b, None, wl, J)
        msf = _merged_fcfs_inputs(b, fb)
        msc = _merged_class_inputs(b, fb, None, wl)
        ft, ftgt, fup, length = _bs_fail_args(b, fb, None, wl)
        real = np.isfinite(ft)
        f64 = dict(dtype=torch.float64, device=dev)
        return dict(
            k=k, s_max=s_max, h=h, q_cap=q_cap, length=length,
            slots=torch.tensor(slots, device=dev),
            fcfs=_merged_tensors(msf, dev), modbs=_merged_tensors(msc, dev),
            trace=(torch.tensor(b.arrival, **f64),
                   torch.tensor(b.cls, dtype=torch.int32, device=dev),
                   torch.tensor(b.need, dtype=torch.int32, device=dev),
                   torch.tensor(b.service, **f64)),
            frec=(torch.tensor(ft, **f64),
                  torch.tensor(ftgt, dtype=torch.int32, device=dev),
                  torch.tensor(fup, **f64)),
            F={"fcfs_fail_scan": msf.t.shape[1] - J,
               "modbs_fail_scan": msc.t.shape[1] - J,
               "bs_fail_scan": ft.shape[1]},
            events={"fcfs_fail_scan": int(np.isfinite(msf.t).sum()),
                    "modbs_fail_scan": int(np.isfinite(msc.t).sum()),
                    "bs_fail_scan": int(2 * b.arrival.size + real.sum()
                                        + (real & (ftgt < len(slots))).sum())})

    def fail_calls(p):
        """name -> (kernel call, plain call) on the same card tensors."""
        a, c, n, v = p["trace"]
        sl = p["slots"]
        tf, _, nf, vf, tuf, isf = p["fcfs"]
        kw_m = dict(s_max=p["s_max"], h=p["h"])
        kw_b = dict(kw_m, q_cap=p["q_cap"], length=p["length"])
        return {
            "fcfs_fail_scan": (
                lambda: K.fcfs_fail_scan_fwd(tf, nf, vf, tuf, isf, k=p["k"]),
                lambda: K.fcfs_fail_scan_ref(tf, nf, vf, tuf, isf,
                                             k=p["k"])),
            "modbs_fail_scan": (
                lambda: K.modbs_fail_scan_fwd(*p["modbs"], sl, **kw_m),
                lambda: K.modbs_fail_scan_ref(*p["modbs"], sl, **kw_m)),
            "bs_fail_scan": (
                lambda: K.bs_fail_scan_fwd(a, c, n, v, *p["frec"], sl,
                                           **kw_b),
                lambda: K.bs_fail_scan_ref(a, c, n, v, *p["frec"], sl,
                                           **kw_b)),
        }

    t_phase = time.time()
    fail_cfgs = {name: [] for name in FAIL_KERNELS}
    for k in (256, 2048):
        for mix in bs_cases.FAIL_MIXES:
            p = fail_inputs(k, DRAIN_CMP_J, mix, seed=1)
            for name, (kern, plain) in fail_calls(p).items():
                out = as_tuple(kern())
                torch.cuda.synchronize()
                t1 = time.time()
                ref = as_tuple(plain())
                torch.cuda.synchronize()
                plain_ms = (time.time() - t1) * 1e3
                for o, r in zip(out, ref):
                    if not torch.equal(o, r):
                        fail(f"{name} at k={k} J={DRAIN_CMP_J} R={REPS} "
                             f"({mix} outages) differs from its plain "
                             f"version")
                if name == "bs_fail_scan" and out[2].any():
                    fail(f"bs_fail_scan overflowed at k={k} with q_cap=J")
                ms = cuda_ms(kern, 3)
                b_ms, b_by = fail_bound(name, REPS, DRAIN_CMP_J, k,
                                        p["events"][name], p["F"][name],
                                        p["length"])
                width = (f"length={p['length']}" if name == "bs_fail_scan"
                         else f"L={DRAIN_CMP_J + p['F'][name]}")
                print(f"[kernel] {name} k={k} {mix} outages R={REPS} "
                      f"J={DRAIN_CMP_J} F={p['F'][name]} {width} events="
                      f"{p['events'][name]}: every raw output equal at "
                      f"tolerance 0 (torch.equal) to the plain version on "
                      f"card, kernel {ms:.3f} ms, plain on card "
                      f"{plain_ms:.1f} ms, bound {b_ms:.5f} ms ({b_by})")
                fail_cfgs[name].append(dict(
                    k=k, mix=mix, F=p["F"][name], events=p["events"][name],
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    err=max_err(out, ref)))
    for name, cfgs in fail_cfgs.items():
        top = next(c for c in cfgs if c["k"] == 2048 and c["mix"] == "bench")
        report[name] = dict(
            name=name, route="cuda", source=SOURCE,
            replaces=FAIL_KERNELS[name][1], launches=None,
            max_abs_err=max(c["err"] for c in cfgs), ms=top["ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=None,
            shape=f"k=2048 R={REPS} J={DRAIN_CMP_J} bench outages",
            configs=cfgs)
    print(f"[kernel] drain-mode comparisons took {time.time() - t_phase:.1f} s")

    # -- 2d. BS-pi on the adversarial cases (bench/bs_cases.py) ------------
    t_phase = time.time()
    for name, make_case in bs_cases.ADVERSARIAL.items():
        case = make_case(BS_ADV_J, BS_ADV_R, 1)
        gcase = case.to(dev)
        kern = "bs_scan" if case.frec is None else "bs_fail_scan"
        out = bs_cases.scan(gcase, K)
        torch.cuda.synchronize()
        t1 = time.time()
        ref = bs_cases.scan_ref(case)              # on the CPU
        plain_ms = (time.time() - t1) * 1e3
        for o, r in zip(out, ref):
            if not torch.equal(o.cpu(), r):
                fail(f"{kern} on the {name} case (R={case.R} J={case.J}) "
                     f"differs from its plain version")
        if name == "wrap" and not (ref[2].any() and not ref[2].all()):
            fail(f"the wrap case should overflow some replications, not all:"
                 f" {ref[2].tolist()}")
        ms = cuda_ms(lambda: bs_cases.scan(gcase, K), 3)
        print(f"[kernel] {kern} {name}: C={case.slots.numel()} slots="
              f"{case.slots.tolist()} h={case.h} q_cap={case.q_cap} "
              f"R={case.R} J={case.J} steps={case.steps}: every raw output "
              f"equal at tolerance 0 (torch.equal) to the plain version on "
              f"CPU, kernel {ms:.3f} ms ({ms * 1e3 / case.steps:.4f} us per "
              f"step), plain on CPU {plain_ms:.1f} ms, rings overflowed in "
              f"{int(ref[2].sum())} of {case.R} replications")
        report[kern].setdefault("adversarial", []).append(dict(
            case=name, ms=ms, plain_cpu_ms=plain_ms, steps=case.steps,
            err=max_err(out, ref)))
        report[kern]["max_abs_err"] = max(report[kern]["max_abs_err"],
                                          max_err(out, ref))
    print(f"[kernel] BS adversarial cases took {time.time() - t_phase:.1f} s")

    # -- 2e. FCFS and ModBS-pi on the adversarial cases (bench/fm_cases.py) -
    t_phase = time.time()
    for name, make_case in fm_cases.ADVERSARIAL.items():
        case = make_case(FM_ADV_J, FM_ADV_R, 1)
        gcase = case.to(dev)
        for kind in ("fcfs", "modbs"):
            kern = f"{kind}_fail_scan" if case.drain else f"{kind}_scan"
            out = fm_cases.scan(gcase, kind, K)
            torch.cuda.synchronize()
            t1 = time.time()
            ref = fm_cases.scan_ref(case, kind)          # on the CPU
            plain_ms = (time.time() - t1) * 1e3
            for o, r in zip(out, ref):
                if not torch.equal(o.cpu(), r):
                    fail(f"{kern} on the {name} case (R={case.R} "
                         f"steps={case.steps(kind)}) differs from its plain "
                         f"version")
            ms = cuda_ms(lambda: fm_cases.scan(gcase, kind, K), 3)
            err = max_err(out, ref)
            print(f"[kernel] {kern} {name}: k={case.k} C="
                  f"{case.slots.numel()} slots={case.slots.tolist()} s_max="
                  f"{case.s_max} h={case.h} R={case.R} steps="
                  f"{case.steps(kind)}: every raw output equal at tolerance "
                  f"0 (torch.equal) to the plain version on CPU, kernel "
                  f"{ms:.3f} ms ({ms * 1e3 / case.steps(kind):.4f} us per "
                  f"step), plain on CPU {plain_ms:.1f} ms")
            report[kern].setdefault("adversarial", []).append(dict(
                case=name, ms=ms, plain_cpu_ms=plain_ms,
                steps=case.steps(kind), err=err))
            report[kern]["max_abs_err"] = max(report[kern]["max_abs_err"],
                                              err)
    print(f"[kernel] FCFS / ModBS adversarial cases took "
          f"{time.time() - t_phase:.1f} s")

    # -- 3. the main path -------------------------------------------------
    K.reset_launches()
    t0 = time.time()
    sw = sweep_many_server(figure1_workload, MAIN_KS, num_jobs=MAIN_J,
                           reps=REPS, policies=POLICIES, device="cuda")
    torch.cuda.synchronize()
    counts = K.launches()
    wall = time.time() - t0
    print(f"[main] sweep_many_server(figure1_workload, {MAIN_KS}, "
          f"num_jobs={MAIN_J}, reps={REPS}) on the card: {wall:.1f} s, "
          f"launches {counts}")
    grid_launches("main", counts, {w: 1 for w, _ in KERNELS.values()})
    K.reset_launches()
    t0 = time.time()
    sw_cells = sweep_many_server(figure1_workload, MAIN_KS, num_jobs=MAIN_J,
                                 reps=REPS, policies=POLICIES, device="cuda",
                                 grid=False)
    torch.cuda.synchronize()
    wall_cells = time.time() - t0
    print(f"[main] the same sweep cell by cell (grid=False): "
          f"{wall_cells:.1f} s, launches {K.launches()}; grid {wall:.1f} s")
    sweeps_equal("main", sw, sw_cells)
    for j, k in enumerate(MAIN_KS):
        for i, pol in enumerate(POLICIES):
            print(f"[main] k={k} {pol:>10}: mean_response="
                  f"{sw.mean_response[i, j]:.6f} p_wait={sw.p_wait[i, j]:.6f}"
                  f" p_helper={sw.p_helper[i, j]:.6f} "
                  f"sim_s={sw.sim_s[i, j]:.3f}")
    for name, (wrapper, _) in KERNELS.items():
        report[name]["launches"] = counts[wrapper]
        report[name]["fig1_launches"] = counts[wrapper]
    for f in ("mean_response", "mean_wait", "p_wait", "p95_response",
              "utilization"):
        if not np.isfinite(getattr(sw, f)).all():
            fail(f"non-finite {f} in the sweep")
    ph = sw.p_helper
    if not (np.isnan(ph[0]).all() and np.isfinite(ph[1:]).all()):
        fail("p_helper must be nan for FCFS only")
    # The paper's claim (Thms 1-2): BS-pi's queueing probability vanishes
    # as k grows in the critical regime, at response times below FCFS's.
    # At these finite k its P[wait>0] is still above FCFS's (the JAX
    # reference gives the same numbers), so the check is the trend.
    bs_pw = sw.p_wait[2]
    if not (np.diff(bs_pw) < 0).all():
        fail(f"BS-pi P[wait>0] does not fall as k grows: {bs_pw}")
    fcfs_r, bs_r = sw.mean_response[0, -1], sw.mean_response[2, -1]
    if not bs_r < fcfs_r:
        fail(f"at k={MAIN_KS[-1]} BS-pi mean response {bs_r} is not below "
             f"FCFS's {fcfs_r}")
    print(f"[main] BS-pi P[wait>0] falls with k: "
          f"{', '.join(f'{x:.6f}' for x in bs_pw)}; at k={MAIN_KS[-1]} its "
          f"mean response {bs_r:.6f} < FCFS {fcfs_r:.6f}")

    small = dict(num_jobs=2000, reps=4, seed=3, policies=POLICIES)
    on_card = sweep_many_server(figure1_workload, (256, 2048), device="cuda",
                                **small)
    on_cpu = sweep_many_server(figure1_workload, (256, 2048), device="cpu",
                               **small)
    for f in ("mean_response", "ci95_response", "mean_wait", "p_wait",
              "ci95_p_wait", "p_helper", "p95_response", "utilization"):
        if not np.array_equal(getattr(on_card, f), getattr(on_cpu, f),
                              equal_nan=True):
            fail(f"small sweep: {f} on the card differs from the CPU")
    print("[main] small sweep (k=256, 2048; J=2000, R=4): card == CPU on "
          "every field")


    # -- 3b. the Fig. 3 path: fig3_traces.run() at its defaults ------------
    K.reset_launches()
    t0 = time.time()
    rows = fig3_traces.run(policies=fig3_traces.SCAN_POLICIES,
                           device="cuda")
    torch.cuda.synchronize()
    counts3 = K.launches()
    wall = time.time() - t0
    print(f"[fig3] fig3_traces.run() (2 datasets x k {FIG3_KS} x 3 loads x "
          f"5 policies, J={FIG3_J}, R={FIG3_R}) on the card: {wall:.1f} s, "
          f"launches {counts3}")
    grid_launches("fig3", counts3, {"fcfs_scan_fwd": 1, "modbs_scan_fwd": 1,
                                    "bs_scan_fwd": 1, "srpt_scan_fwd": 2})
    K.reset_launches()
    t0 = time.time()
    rows_cells = fig3_traces.run(policies=fig3_traces.SCAN_POLICIES,
                                 device="cuda", grid=False)
    torch.cuda.synchronize()
    wall_cells = time.time() - t0
    print(f"[fig3] the same run cell by cell (grid=False): "
          f"{wall_cells:.1f} s, launches {K.launches()}; grid {wall:.1f} s")
    for pol in fig3_traces.SCAN_POLICIES:
        g, c = (sum(r["sim_s"] for r in rs if r["policy"] == pol)
                for rs in (rows, rows_cells))
        print(f"[fig3] {pol:>10} sim_s summed over the 12 cells: grid "
              f"{g:.2f} s, cell by cell {c:.2f} s")
    strip = [{c: v for c, v in r.items() if c != "sim_s"} for r in rows]
    if strip != [{c: v for c, v in r.items() if c != "sim_s"}
                 for r in rows_cells]:
        fail("the Fig. 3 rows of the grid differ from the rows cell by cell")
    print("[fig3] grid rows == cell-by-cell rows on every column but sim_s")
    for r in rows:
        print(f"[fig3] {r['dataset']} k={r['k']} load={r['load']} "
              f"{r['policy']:>10}: mean_response={r['mean_response']:.6f} "
              f"p_wait={r['p_wait']:.6f} p95={r['p95_response']:.6f} "
              f"util={r['utilization']:.6f} sim_s={r['sim_s']}")
    if len(rows) != 60:
        fail(f"the Fig. 3 path gave {len(rows)} rows, expected 60")
    for r in rows:
        for f in ("mean_response", "p_wait", "p95_response"):
            if not np.isfinite(r[f]):
                fail(f"non-finite {f} in Fig. 3 row {r}")
    for name, (wrapper, _) in KERNELS.items():
        report[name]["fig3_launches"] = counts3[wrapper]
        report[name]["launches"] += counts3[wrapper]
    report["srpt_scan"]["launches"] = counts3["srpt_scan_fwd"]
    small3 = dict(num_jobs=1500, reps=2, ks=(512,), loads=(0.85,),
                  policies=fig3_traces.SCAN_POLICIES)
    card3 = fig3_traces.run(**small3, device="cuda")
    cpu3 = fig3_traces.run(**small3, device="cpu")
    for a, b in zip(card3, cpu3):
        if ({c: v for c, v in a.items() if c != "sim_s"}
                != {c: v for c, v in b.items() if c != "sim_s"}):
            fail(f"small Fig. 3 run: card row {a} differs from CPU row {b}")
    if len(card3) != len(cpu3) or len(card3) != 10:
        fail("small Fig. 3 run: wrong row count")
    print("[fig3] small run (J=1500, R=2, k=512, load=0.85): card == CPU on "
          "every column but sim_s")

    # -- 3c. the drain path: sweep_many_server(..., failures=) ------------
    K.reset_launches()
    t0 = time.time()
    swf = sweep_many_server(figure1_workload, DRAIN_KS, num_jobs=MAIN_J,
                            reps=REPS, policies=POLICIES, device="cuda",
                            failures=bench_failures)
    torch.cuda.synchronize()
    counts_d = K.launches()
    wall = time.time() - t0
    print(f"[drain] sweep_many_server(figure1_workload, {DRAIN_KS}, "
          f"num_jobs={MAIN_J}, reps={REPS}, failures=<bench_failures: mtbf "
          f"= h/4, mttr = h/400 per server>) on the card: {wall:.1f} s, "
          f"launches {counts_d}")
    grid_launches("drain", counts_d,
                  {w: 1 for w, _ in FAIL_KERNELS.values()})
    K.reset_launches()
    t0 = time.time()
    swf_cells = sweep_many_server(figure1_workload, DRAIN_KS,
                                  num_jobs=MAIN_J, reps=REPS,
                                  policies=POLICIES, device="cuda",
                                  failures=bench_failures, grid=False)
    torch.cuda.synchronize()
    wall_cells = time.time() - t0
    print(f"[drain] the same sweep cell by cell (grid=False): "
          f"{wall_cells:.1f} s, launches {K.launches()}; grid {wall:.1f} s")
    sweeps_equal("drain", swf, swf_cells)
    print("[drain] k=2048 is left out: with the default queue_cap=8192 "
          "BS-pi's helper-wait ring overflows there under these outages, "
          "on the reference too (the class blocks run above unit load by "
          "design)")
    for j, k in enumerate(DRAIN_KS):
        jc = MAIN_KS.index(k)
        for i, pol in enumerate(POLICIES):
            print(f"[drain] k={k} {pol:>10}: mean_response="
                  f"{swf.mean_response[i, j]:.6f} (clean "
                  f"{sw.mean_response[i, jc]:.6f}) p_wait="
                  f"{swf.p_wait[i, j]:.6f} (clean {sw.p_wait[i, jc]:.6f}) "
                  f"availability={swf.availability[i, j]:.6f} "
                  f"sim_s={swf.sim_s[i, j]:.3f}")
    for name, (wrapper, _) in FAIL_KERNELS.items():
        report[name]["launches"] = counts_d[wrapper]
    for f in ("mean_response", "mean_wait", "p_wait", "p95_response",
              "utilization", "availability"):
        if not np.isfinite(getattr(swf, f)).all():
            fail(f"non-finite {f} in the drain sweep")
    if not ((swf.availability > 0) & (swf.availability <= 1)).all():
        fail(f"availability outside (0, 1]: {swf.availability}")

    for k in (256, 2048):
        wl = figure1_workload(k)
        b = wl.sample_traces(DRAIN_SMALL_J, DRAIN_SMALL_R, seed=3)
        fb = bench_failures(wl, b, seed=3)
        for pol in POLICIES:
            on_card = engines.simulate(pol, b, wl=wl, failures=fb,
                                       device="cuda")
            on_cpu = engines.simulate(pol, b, wl=wl, failures=fb,
                                      device="cpu")
            for fld in dataclasses.fields(on_cpu):
                x = getattr(on_card, fld.name)
                y = getattr(on_cpu, fld.name)
                if (x is None) != (y is None) or (
                        x is not None and not np.array_equal(
                            x, y, equal_nan=True)):
                    fail(f"small drain run {pol} k={k}: {fld.name} on the "
                         f"card differs from the CPU")
    print(f"[drain] small runs (J={DRAIN_SMALL_J}, R={DRAIN_SMALL_R}, "
          f"k=256, 2048, bench outages): card == CPU on every "
          f"BatchSimResult field, availability included")

    # -- 3d. the stream path: simulate_stream on the carried kernels ------
    stream_path(dev, report)

    # -- 3e. the paper's policy set: the event engine as the oracle -------
    paper_path(dev, report)

    # -- 3f. the theory path: the loss queue, Property 1, the drivers -----
    theory_path(dev, report, sw)

    # -- 4. kernel times at the main path's largest shape -----------------
    for k in MAIN_KS[:-1]:            # and FCFS / ModBS at the other ks
        t, p = inputs(k, MAIN_J, seed=0)
        for name, (kern, _) in calls(t, p).items():
            if name == "bs_scan":
                continue
            ms = cuda_ms(kern, 2)
            print(f"[time] {name} k={k} R={REPS} J={MAIN_J}: {ms:.3f} ms per "
                  f"launch ({ms * 1e3 / MAIN_J:.4f} us per step)")
            report[name][f"main_ms_k{k}"] = ms
    t, p = inputs(MAIN_KS[-1], MAIN_J, seed=0)
    for name, (kern, _) in calls(t, p).items():
        ms = cuda_ms(kern, 2)
        rate = REPS * MAIN_J / (ms / 1e3)
        b_ms, b_by = bound(name, REPS, MAIN_J, MAIN_KS[-1])
        steps = 2 * MAIN_J if name == "bs_scan" else MAIN_J
        print(f"[time] {name} k={MAIN_KS[-1]} R={REPS} J={MAIN_J}: "
              f"{ms:.3f} ms per launch ({ms * 1e3 / steps:.4f} us per "
              f"step), {rate:.0f} jobs/s, bound {b_ms:.5f} ms ({b_by})")
        report[name].update(main_ms=ms, main_jobs_per_s=rate,
                            main_bound_ms=b_ms,
                            main_shape=f"k={MAIN_KS[-1]} R={REPS} J={MAIN_J}")

    timed = [("sdsc",) + srpt_inputs(FIG3_KS[-1], FIG3_J, seed=0)
             + (NU, FIG3_KS[-1], FIG3_J),
             ("kit",) + srpt_inputs(FIG3_KS[-1], FIG3_J, seed=0,
                                    dataset="kit")
             + (NU, FIG3_KS[-1], FIG3_J)]
    t, NU_b = srpt_cases.burst_case(SRPT_BURST_J, 512, FIG3_R, batch=100,
                                    gap=0.5, seed=0, device=dev)
    timed.append(("burst", t, 2048, NU_b, 512, SRPT_BURST_J))
    for label, t, Q, nu, k, J in timed:
        for sf in (True, False):
            kw = dict(Q=Q, NU=nu, sf=sf)
            out = K.srpt_scan_fwd(*t, **kw)
            ms = cuda_ms(lambda: K.srpt_scan_fwd(*t, **kw), 2)
            b_ms, b_by = srpt_bound(FIG3_R, J, out[0].cpu().numpy())
            n = srpt_cases.jobs_in_system(out[0].cpu().numpy())
            pol = "sf" if sf else "ff"
            print(f"[time] srpt_scan {label} {pol} k={k} Q={Q} R={FIG3_R} "
                  f"J={J}: {ms:.3f} ms per launch "
                  f"({ms * 1e3 / (2 * J):.3f} us per event), jobs in "
                  f"system per event mean {n.mean():.1f} max {n.max()}, "
                  f"bound {b_ms:.5f} ms ({b_by})")
            tag = "" if label == "sdsc" else f"{label}_"
            report["srpt_scan"][f"main_ms_{tag}{pol}"] = ms
            report["srpt_scan"][f"main_bound_ms_{tag}{pol}"] = b_ms
            report["srpt_scan"][f"main_n_mean_{tag}{pol}"] = float(n.mean())
    report["srpt_scan"]["main_shape"] = (f"k={FIG3_KS[-1]} Q={timed[0][2]} "
                                         f"R={FIG3_R} J={FIG3_J}")

    p = fail_inputs(MAIN_KS[-1], MAIN_J, "bench", seed=0)
    print(f"[time] drain kernels at k={MAIN_KS[-1]} R={REPS} J={MAIN_J}, "
          f"bench outages; BS-pi with q_cap=J={MAIN_J}: the default 8192 "
          f"ring overflows at this k (see [drain])")
    for name, (kern, _) in fail_calls(p).items():
        ms = cuda_ms(kern, 2)
        b_ms, b_by = fail_bound(name, REPS, MAIN_J, MAIN_KS[-1],
                                p["events"][name], p["F"][name],
                                p["length"])
        steps = (p["length"] if name == "bs_fail_scan"
                 else MAIN_J + p["F"][name])
        print(f"[time] {name} k={MAIN_KS[-1]} R={REPS} J={MAIN_J} "
              f"F={p['F'][name]} steps={steps}: {ms:.3f} ms per launch "
              f"({ms * 1e3 / steps:.3f} us per step), bound {b_ms:.5f} ms "
              f"({b_by})")
        report[name].update(main_ms=ms, main_bound_ms=b_ms,
                            main_steps=steps,
                            main_shape=f"k={MAIN_KS[-1]} R={REPS} "
                                       f"J={MAIN_J} bench outages")

    ops = sort_inputs(SORT_WS[0], 2)
    ms = cuda_ms(lambda: K.stable_sort_fwd(*ops, num_keys=2), 20)
    k1, k2 = ops[0], ops[1]

    def torch_sort():
        o1 = torch.sort(k2, dim=1, stable=True).indices
        o2 = torch.sort(k1.gather(1, o1), dim=1, stable=True).indices
        return o1.gather(1, o2)

    lib_ms = cuda_ms(torch_sort, 20)
    t1 = time.time()
    K.stable_sort_ref(*ops, num_keys=2)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t1) * 1e3
    b_ms, b_by = sort_bound(SORT_R, SORT_WS[0], 2)
    print(f"[time] stable_sort R={SORT_R} W={SORT_WS[0]} keys=2: "
          f"{ms:.4f} ms per launch; two stable torch.sort passes "
          f"{lib_ms:.4f} ms; plain version {plain_ms:.2f} ms; bound "
          f"{b_ms:.6f} ms ({b_by})")
    report["stable_sort"] = dict(
        name="stable_sort", route="cuda", source=SRPT_SOURCE,
        replaces=SORT_REPLACES, launches=report["srpt_scan"]["launches"],
        launched_in="srpt_scan's in-kernel sort (since the redesign "
                    "warp odd-even passes with a warp merge sort behind "
                    "them, same order; this block-wide bitonic entry is "
                    "not on the main path)",
        max_abs_err=max(sort_errs), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"R={SORT_R} W={SORT_WS[0]} keys=2")

    report.update(serving_path(dev))
    gc.collect()                      # the dense phase's engine and weights
    torch.cuda.empty_cache()
    report.update(moe_path(dev))
    gc.collect()                      # the MoE phase's engine and weights
    torch.cuda.empty_cache()
    report.update(rwkv_path(dev))
    gc.collect()                      # the RWKV phase's engine and weights
    torch.cuda.empty_cache()
    report["mamba_scan"], report["gmm"]["jamba_cut"] = hybrid_path(dev)
    gc.collect()                      # the hybrid phase's engine and weights
    torch.cuda.empty_cache()
    xa = xattn_path(dev)
    gc.collect()                      # the cross-attention phase's weights
    torch.cuda.empty_cache()
    ml = mla_path(dev)
    fl, de, gm = (report[k] for k in ("flash_attention", "decode_attention",
                                      "gmm"))
    fl["xattn"] = [{k: v for k, v in c.items() if k != "shape"}
                   for c in xa["flash"]]
    fl["mla"] = [{k: v for k, v in c.items() if k != "shape"}
                 for c in ml["flash"]]
    de["xattn"] = xa["decode"]
    gm["deepseek"] = ml["gmm"]
    gm["max_abs_err"] = max([gm["max_abs_err"]]
                            + [c["err"] for c in ml["gmm"]])
    for entry, cases in ((fl, xa["flash"] + ml["flash"]),
                         (de, xa["decode"])):
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [c["err"] for c in cases])
    fl["xattn_launches"] = de["xattn_launches"] = xa["launches"]
    fl["mla_launches"] = gm["mla_launches"] = ml["launches"]
    fl["xattn_serve_s"], gm["mla_serve_s"] = xa["serve_s"], ml["serve_s"]
    gc.collect()                      # the MLA phase's weights
    torch.cuda.empty_cache()
    with plain_epoch_runs() as plain:
        dr = driver_path(dev, report, plain)
    fl["driver"] = [{k: v for k, v in c.items() if k != "shape"}
                    for c in dr["flash"]]
    de["driver"], gm["driver"] = dr["decode"], dr["gmm"]
    for entry, cases in ((fl, dr["flash"]), (de, dr["decode"]),
                         (gm, dr["gmm"])):
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [c["err"] for c in cases])
    for entry, name in ((fl, "flash_attention"), (de, "decode_attention"),
                        (gm, "gmm")):
        entry["driver_launches"] = dr["launches"][name]
    fl["driver_serve_s"], fl["driver_peak_gb"] = dr["serve_s"], dr["peak_gb"]
    fl["driver_weights_draw_s"] = dr["draw_s"]
    for pol, name in zip(POLICIES, STREAM_KERNELS):
        report[name]["driver_run_s"] = dr["epoch_s"][pol]
        report[name]["driver_plain_run_s"] = dr["plain_epoch_s"][pol]
    gc.collect()                      # the serving driver's weights
    torch.cuda.empty_cache()
    train_path(dev, report)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[done] all phases in {time.time() - t_start:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
