#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   port's CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc per
   source, all started together; the batched and single-client LSH
   kernels share a source).
2. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at larger ones from the JAX kernels'
   contract points, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (torch.matmul
   with the projection matrix materialised for the LSH kernels,
   torch.cdist(p=0) on unpacked bits for the Hamming kernel): device
   time per call from torch.profiler, and CUDA-event medians of whole
   calls after warm-up (`timings`). Both exact selection kernels print
   their launch plan (`selection.select_plan`), are launched twice and
   required bit-identical, and are bounded on the route the TPU kernel
   prices (the +-1 Gram's 2*M*M*W*32 int8 operations at 1,979 TOP/s;
   `popc_bound_ms` beside it: M*M*W popcounts at 16 a clock an SM), with
   `torch._int_mm` on the unpacked +-1 codes timed as a Gram-only
   yardstick (`gram_library_ms`, never called by the port) where its
   (M, M) product fits. The one-shot selection runs at the main shape,
   at M = 1,024, 4,096, 16,384 and 46,489 (held past M = 8,192 against
   `fused_select_tiled_ref` in 4096 x 4096 tiles), at N = 128 and at
   N = 200 (the knockout instance). The column-tiled selection is also
   held against the one-shot kernel wherever that runs (to M = 46,489)
   and checked at M = 65,536 past it; the one-shot exchange at the main
   shape, at C = 1,024 and at the ANN federations' M = 4,096 and 65,536
   (N = 16, R = 64, C = 10; the plain version's peak allocation
   printed), the streamed exchange against both plain versions up to a
   100,352-class vocabulary, each exchange launched twice and required
   bit-identical, with the wrapper's launch plan (`oneshot_plan`,
   `streamed_plan`) printed and its kernels timed as the plan launches
   them; the
   per-row ANN selection (the grouped entry point's one-row instance,
   one slot a row) runs on
   `ann_candidates` at the defaults (prefix 10, probes 8): the main
   shape, all ties, clustered codes at M = 4096 and 65,536, and with
   prefix_bits=0 against the one-shot kernel, with its plan
   (`selection.ann_plan(one_row_slots=True)`); the grouped ANN
   selection on `bucket_candidates` at the same five shapes, against
   its plain version and the per-row function, launched twice
   (bit-identical), with its plan (`selection.ann_plan`); both bounded
   on the grouped route (the +-1 Gram of each client against its
   slot's valid candidates at 1,979 TOP/s; the S x K lists read once); the
   flash-attention kernel at the serving path's shape (N = 4 * 24 heads,
   Sq = Sk = 2048, dh = 128, f32, causal) and the same in bf16, at the
   JAX kernel's contract points, bidirectional with Sq != Sk, at lengths
   that are no tile multiple, in bf16, at dh = 256 and on the model's GQA
   layout (Minitron-4B's 24 over 8 heads, grok-1's 48 over 8 and
   whisper's bidirectional encoder: 12 heads, dh 64, 1,500 frames),
   timed beside torch's scaled_dot_product_attention
   (`library_ms`, never called by the port) and bounded on its route
   (`flash_attention.attention_flops` on the tensor cores: f32 by 3xTF32
   at 495 / 3 TFLOP/s, bf16 at 989;
   `cuda_core_bound_ms` at the f32 CUDA-core 67). The Hamming checks
   print the path the launch took (small or tiled). The LSH checks print
   the split length L (`lsh_projection.split_len`, from P alone), the
   instance the launch took (single / few / many rows, with rows and bits
   per block) and `order_equal`: the kernel's sums equal to the order
   twin `ref.lsh_project_sums_split_order` bit for bit (and the
   single-client sums to the batched row); either raises when false.
   The single-client kernel is also checked at the main shape from hash
   rows 2^31 + 12,345 and 2^32 - 200,000 (wrapping mid-vector), against
   its plain version and the order twin at that row offset.
   The batched LSH checks also print the row groups the wrapper launched
   and the call's peak allocation, and raise when it passes the plan's
   scratch and output (M=65,536, P=12,288 runs in groups).
   One JSON line per kernel and shape.
3. Drives the main paths, every kernel's launch count set to 0 just
   before each and read just after: `run_federation("mnist", rounds=2,
   backend="kernel")` on the card, the same with `tiling="tiled"`, and
   with `backend="ann"`. The one-shot run must launch the LSH, one-shot
   selection and one-shot exchange kernels and no other, the tiled run
   the LSH kernel and the tiled pair, the ANN run the LSH kernel, the
   grouped ANN selection (exactly twice; the per-row function never)
   and the one-shot exchange. A run with
   `backend="oracle"` and the tiled run must give the one-shot run's
   round-0 neighbour ids and valid masks, the ANN run its round-0 id
   sets, in the order of `ann_select_ref` on the round-0 codes; each
   within 0.02 accuracy per round. On the one-shot run's final state,
   each client's own code (`client_lsh_code`, the single-client kernel)
   must equal its published row, and the unfused Eq. 6-8 composition
   through the Hamming kernel must give the fused kernel's ids. At
   M = 65,536, `select_partners` must take the tiled kernel with
   `tiling="auto"` and the grouped ANN kernel with `backend="auto"`
   (ids equal to the per-row function's; K, occupancy, the grouped and
   the per-row route's candidate and kernel times, and recall against
   the tiled exact kernel). Three
   profiled runs (one-shot, tiled, ANN) break round 1 down into its
   phases' host time, the device's busy time and the kernels that took
   it (`profile_round`).
4. The paper's threats and comparisons (Figs. 4-5, Table 2), counts set
   to 0 just before each run and read just after: `run_federation(
   "mnist", rounds=3, attack="lsh_cheat", attack_frac=0.5,
   attack_start=0)` through the plain versions, the one-shot kernels, the
   tiled kernels and `backend="ann"`. Each kernel run must launch its
   path's kernels (the plain run none) and give the plain run's round-0
   neighbour ids and valid masks (ANN: id sets) and accuracy within 0.02
   per round; round 0 is attacked, so five clients carry the target's
   forged code and the kernels' tie order is held on it. Prints per round
   the attacker admission rate, the honest and attacker ranking scores,
   the valid-neighbour share, the honest cohort's accuracy and seconds.
   Then `attack="lie_in_reveal"` on the one-shot kernels must give
   honest_reporter_frac 0.5 in every round. Then SILO, FedMD, ProxyFL and
   KD-PDFL, built by `make_program` at the mnist defaults, two rounds
   each on the card and on the CPU from the same seed: finite losses,
   accuracy within 0.02 of the CPU run, the LSH kernel launched (by
   `init_state`) and no other; seconds per round printed beside the CPU's.
5. Path 4, LM serving: `serve("minitron-4b", reduced=False, batch=4,
   prompt_len=2048, max_new=32)` on the card (Minitron-4B at its
   published widths, 32 layers, random weights from seed 0), launch
   counts set to 0 just before: the flash-attention kernel must launch
   exactly 32 times (once per layer of the prefill, never in decode) and
   no other kernel. The same call on the same weights with the "naive"
   attention (no launch) must give prefill logits within rtol 1e-4, atol
   1e-4, and the same tokens, except from a step where the naive run's
   two largest logits lie within 1e-3. Prints the prefill seconds, the
   decode tokens/s, the peak device memory, the kernel's device time in
   a profiled prefill and a profile of three decode steps (host ms,
   device busy ms, idle share, launches, costliest kernels).
   Then the other LM families at full width (`families_path`), batch 4,
   32 new tokens, f32, random weights from seed 0, counts set to 0 just
   before each `serve`: grok-1 (2 of 64 layers, prompt 2048: flash 2
   launches), llama-3.2-vision (one (A, A, A, A, X) repetition, 5 of 100
   layers, 1,601 vision patches: 4), recurrentgemma (26 layers: none,
   its "L" blocks take the window route), xlstm (24 layers: none) and
   whisper (12 + 12 layers, 1,500 frames, prompt 448: 12 bidir + 12
   causal); no other kernel may launch. Where flash runs, the naive
   attention on the same weights must agree as above; recurrentgemma,
   xlstm and kimi-k2 (whose full width does not fit one card in f32;
   its reduced config widened to 16 experts, top 8) run their reduced
   config on the card and the CPU from the same weights (prefill logits
   rtol 1e-4, atol 1e-4; the same tokens but after a near-tie). Prints
   per model the layers run, parameters, prefill s, decode tokens/s,
   peak memory, flash's device ms in a profiled prefill, three profiled
   decode steps and grok's per-layer MoE dropped_frac.
5a. LM training, which launches no kernel (the flash kernel has no
   backward; the training route takes the plain attention, as the JAX
   package's does). `train_path`: the reduced Minitron-4B's step on the
   card against the CPU (`train_card_vs_cpu`), a checkpoint round trip
   and `train("minitron-4b", reduced=False, batch=2, seq=512,
   remat="block", steps=4)` with one profiled step. `train_families_path`:
   (a) the reduced grok-1, kimi-k2 (16 experts, top 8), recurrentgemma,
   xlstm, whisper and llama-3.2-vision through `train_card_vs_cpu`; (b)
   `train(arch, reduced=False, ...)` for recurrentgemma-2b (26 layers, 2
   x 512, remat "block"), whisper-small (12 + 12 layers, 2 x 448 tokens
   over 1,500 frames) and xlstm-350m (24 layers, 2 x 256, remat "none"),
   counts set to 0 just before and 0 just after, finite losses and grad
   norms, peak under 80 GB, one profiled step each; (c) kimi-k2 at its
   published widths (D 7,168, F 2,048, top 8, capacity factor 1.25) cut
   to 1 of 61 layers and 16 of 384 experts, three steps of
   `make_train_step` (2 x 512, remat "block"): finite positive moe_aux
   and each step's dropped_frac. Prints per run the parameters, s per
   step, tokens/s, peak memory and the profiled step's device busy ms,
   idle share and launches.
5b. The twins of the JAX package's smoke scripts and examples
   (`examples_path`, after training): `scripts/torch_{service,chaos,ann,
   tiled}_smoke.py` and `examples/torch_{attack_resilience,quickstart,
   serve_batch,train_lm}.py`, each `main(argv)` called in this process
   on the card at its JAX script's sizes (train_lm 20 of its 200 steps),
   counts set to 0 just before each and read just after: each must
   launch the kernels of its row in `EXAMPLES` (train_lm none), and its
   own assertions fail the run. One `examples` line per twin: seconds,
   launches and the numbers its `main` returns (service requests/s,
   chaos fault trace, ANN recall and K, attack accuracies, serve_batch
   prefill s and decode tokens/s, train_lm losses and s a step).
6. Sharding (`sharding_path`, after training, before the service):
   (a) a vector of Minitron-4B's 4,190,309,376 parameters, padded to
   4,190,310,400 and hashed from a seed by global index
   (`fill_by_index`), gets its code from `sharded_lsh_code` over 4 gloo
   ranks spawned on this card (two NCCL ranks cannot share a GPU), each
   making and projecting only its quarter through the single-client
   kernel at row offsets up to 3,142,732,800; the count is set to 0 just
   before and must read 1 on every rank just after. The unsharded kernel
   over the whole 16.8 GB vector in this process must give the same bit
   wherever |sum| > 1e-3. The last rank's launch (rows 3,142,732,800 on)
   is also held against the plain version on its shard: sums within
   1e-5 of |sum| + ||x||, equal bits wherever |sum| > 1e-3. Prints both
   kernels' ms (each rank's alone, in turn), the plain version's s and
   the ranks' all-reduce ms, which gloo takes through the host.
   (b) expert parallelism on the same ranks, each making only its slice
   of the weights (one generator per expert and FFN block), placed by
   `moe_specs` on a (1, 4) mesh with the tokens (`_tp_moe`): grok-1's MoE
   layer at full width (E 8, D 6,144, F 32,768, 19.3 GB in f32; FFN
   width sharded), 4 x 2,048 tokens at capacity factor 4 (C = T, so
   nothing can drop), and kimi-k2's layer at full width (D 7,168, F
   2,048, top 8) with 16 of its 384 experts, capacity factor 2 (C = T;
   experts sharded): output within 1e-4 of the
   unsharded `apply_moe` in this process, load_balance within 1e-4,
   dropped_frac equal; ms per call and peak memory per rank. (c) the
   local shards of Minitron-4B's params (2 layers) placed by
   `param_specs` on a (2, 2) ("data", "model") gloo mesh of the ranks:
   each its spec's block of the global tensor. (d) Minitron-4B (4 of 32
   layers) placed on a (1, 1) NCCL mesh of this process: a 2,048-token
   prefill on the local shards launches flash 4 times, nothing else,
   and gives the unplaced prefill's logits bit for bit, and so does the
   tensor-parallel prefill on the placed params themselves. (e)
   `launch/dryrun.py` for kimi-k2 x train_4k on meta: bytes per device
   on 16x16, params + AdamW state equal to the spec arithmetic written
   out here (`spec_elems`). Every process group made is destroyed.
6a. The tensor-parallel forward (`sharding_tp_path`, after sharding):
   Minitron-4B (4 of 32 layers; 6 query and 2 K/V heads a rank, whole
   heads), phi3-medium-14b (2 of 40; 10 query heads a rank, its 10 K/V
   heads gathered) and recurrentgemma-2b (3 of 26, one R, R, L
   repetition; 10 query heads over 1 K/V head, every head on every rank,
   the R block split on its channels) at full width in f32, one prompt
   of 2,048 tokens, first unsharded in this process (the second call
   timed), then over 4 gloo ranks spawned on this card on a (1, 4)
   ("data", "model") mesh (`sharding_tp_rank`): each rank draws the whole
   params from the same seed and keeps its shards only; every
   count is set to 0 just before each prefill and read just after, and
   its collectives are recorded (`launch.dryrun.CollectiveCounter`);
   Minitron-4B then decodes 4 teacher-forced tokens on the sharded
   cache. The ranks' vocabulary shards of the logits, side by side, must
   be within 1e-4 of the largest |logit| of the unsharded forward
   (`TP_REL_TOL`; f32, the row-parallel sums over 4 ranks reordered),
   each rank's collective bytes and counts equal to `tp_bytes` (written
   out here from the head rule), flash launched once per "A" layer (4,
   2, 0 a rank) and nothing else, and each rank's attention core at its
   own head counts (phi3: 10 query heads, K/V taken one per query head)
   within 2e-5 of the naive route on the same inputs (`tp_core_check`).
   Gloo carries CUDA tensors through its
   c10d ops, not through the functional collectives DTensor issues
   (they segfault), so these ranks take the port's c10d transport.
   Prints a `sharding_tp` line per model (errors, bytes, rank and
   unsharded prefill ms, one gloo all-reduce of the row-parallel
   payload in ms, peak GB per rank) and a "tensor-parallel prefill"
   `main_path_launches` line.
6b. The federation with transformer clients (`fed_dryrun_path`, after
   sharding, before the analysis gate): `launch/fed.py`'s dry run
   (`prepare_fed_dryrun`, `run_fed_dryrun`; reduced phi3-medium-14b
   clients in bf16, drawn on the card) at 256 clients (the JAX
   default), 1,024 public and tiled (CI's run) and 256 through the ANN
   selection under `lsh_cheat` with a gossip epoch (G = 2), counts set
   to 0 just before each run and read just after: one timed segment
   each, the first at its size (`"warmup_segments": 0`: no warm-up of
   its own, so its seconds and peak include the allocator's growth; the
   16-client segments below run first and build and load every kernel),
   which launches its path's LSH, selection
   and exchange kernels and flash, no other, and flash exactly 2 x 2
   times per personal exchange and 2 x 1 per public one (2 layers of the
   exchange's vmapped forward calls, the own forwards and the neighbour
   web, each one launch through the flash op's vmap rule), so never in
   the update; each protocol phase's synchronised wall seconds
   (`timed_phases`). At 256 clients every client's wq, wk and wv in
   every layer moved, and the device busy time is estimated from the
   profiled vmapped calls of a period (`unit_busy_ms`: the own forwards,
   the neighbour web, one local step of all M clients). Each run prints
   the dry run's JSON (the JAX keys, flops, wall_s, peak, state and temp
   bytes) with its launches and set-up seconds. 16 clients drawn on the
   CPU, one segment on the card through flash, one on the card under
   `set_attn_impl("naive")` and one on the CPU: ids equal, flash 4
   launches and none in the other two, flops equal; flash against naive
   and card against CPU within FED16_LIMITS: the relative L2 distance of
   the worst leaf of the new Adam moments m and v (they hold the
   gradient) and of the update p1 - p0, of the exchange's target_ref
   and l_ij, and mean_neighbor_loss's, with valid masks and has_target
   equal. Three controls must each be refused: the card's exchange with
   flash unmasked (a wrong attention), its moments and update with wq,
   wk, wv given no gradient (the update through a kernel without a
   backward), and with the gradient doubled (a wrong loss scale). The
   path's kernels at its shapes, each against its
   plain version, timed, with its bound and library call: LSH at M =
   256 and 1,024, P = 1,640,448 (reduced phi3, padded), 128 bits
   (`torch.matmul` with R materialised); the one-shot selection at 256,
   the tiled at 1,024 and the grouped ANN at 256 (128 bits, N = 8); the
   one-shot exchange at (256, 8, 8, 1,024) and the streamed at (1,024,
   8, 8, 1,024); flash at B 8, S 32, 4 query over 1 KV head, dh 64,
   causal, f32 and bf16, and through its vmap rule as the neighbour web
   calls it at 256 clients (a nested vmap over 256 x 8 of B 8: a folded
   B of 16,384, bf16; one launch), as the own forwards call it at 256
   and 1,024 clients (a vmap of B 8: folded B 2,048 and 8,192), each
   flash check with its launch plan (`flash_attention.flash_plan`:
   configuration, items, grid, shared memory), and at the f32 contract
   point under vmap within the contract's 2e-5, its taint wrapper rule
   firing once with the inputs' labels on the output. Then one
   `client_axis` line: the card, the one-shot mnist round's seconds
   (round 1 of the main path, unprofiled; and under the profiler), idle
   share and host ms
   per phase (the profile of 3), the dry run's seconds a period at 256
   and 1,024 clients, its peak at 1,024 and `unit_busy_ms`; the whole
   script's seconds come with the `seconds` line at the end.
7. The continuous service (`service_path`, last, since it holds cuDNN
   to deterministic algorithms): `run_service_federation("mnist",
   periods=4, reselect_every=4)` on the card with churn
   "1:leave:3,1:leave:8,2:join:3", gossip budgets
   "4,4,2,4,1,4,3,4,4,2" and a fault plan of every kind (SERVICE,
   SERVICE_FAULTS), counts set to 0 just before and read just after: the
   LSH, one-shot selection and one-shot exchange kernels launch, no
   other. The same plan with a crash at period 2: the newest snapshot
   truncated, resumed (one fallback, a second crash at 2), resumed to
   the end; state, rounds and ledger payloads equal the uninterrupted
   run's bit for bit. Periods 0-1 on the CPU: every global round's ids
   (all ranks, masked ones included) and valid masks equal, accuracy
   within 0.02 per round. `select_phase(active=, score_scale=)` on the
   final state through the tiled and the grouped ANN kernels, each
   launched once, ids and masks equal to the CPU's plain versions.
   `serve_personalized` from the checkpoint (256 requests): logits
   within 1e-5 of a direct `apply_client_model` on the card. Prints per
   period s, active_frac, acc and the fault counters; the server's
   requests/s, p50 and served_acc. The kernel checks of 2 also hold the
   selection kernels with -inf score columns (departed clients: one-shot
   at M = 10, 1,024 with N = 200 and 46,489; tiled at 10 and 65,536;
   grouped ANN at 10 and 65,536 clustered; ids compared on every rank)
   and both exchange kernels on rows with N-1 of N and all ranks masked.
8. The analysis gate on the card (`analysis_path`, before the service):
   `repro_torch.analysis.__main__.run_gate("cuda")`: every registry
   entry launched once at its contract shape and held against its plain
   twin on the card at its exactness class, the three shared-memory
   mirrors (`select_smem_bytes`, `ann_smem_bytes`,
   `fused_exchange_smem_bytes`) equal to their Python functions at every
   entry point, the 16 taint targets clean on the card through the
   kernel backends (the LSH, one-shot selection and one-shot exchange
   kernels launched during that run, and their wrappers' label rule
   fired), the completeness walk and the host-sync lint clean. Then the
   probe: the exchange kernel's outputs on a web that did not pass
   `public_ref_logits` carry client-params and client-data, which only
   the wrapper rule can give them; and the three torch leak fixtures,
   each exactly its one finding on the card. Any finding fails the run.
   Prints the gate's seconds per part, its finding counts, and the 16
   targets' seconds run plainly and under the check (warm, the same
   process).
9. Prints {"phase": "seconds", ...}, the wall seconds of each section
   (build, kernel checks, main paths, profiles, attack, baselines,
   serve, families, train, train_families, examples, sharding,
   sharding_tp, fed_dryrun, analysis, service),
   then
   {"kernels": [...]}
   for every kernel of the paths driven (the
   per-row ANN function, which no path takes since the route took the
   per-bucket form, is checked in 2 only), then, last,
   {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, without a CUDA device or
without the rest of the repository. Tolerances: LSH sums within
1e-5 * (|plain| + ||x_row||_2) and codes equal on every bit whose |sum|
> 1e-3 (a client's own code against its published row likewise);
selection ids and weights equal (one-shot, tiled, per-row and grouped
ANN, the last two one kernel); Hamming
distances equal; unfused selection ids equal to the fused kernel's
except where two Eq. 8 weights are within 1 ulp; one-shot exchange l_ij
and target within rtol 1e-5 (atol 1e-5 for target entries near 0);
streamed exchange l_ij and target within rtol 2e-5, atol 1e-5 of both
plain versions; valid and has_target equal; flash attention max abs
error 2e-5 in f32 and 2e-2 in bf16 on unit-normal inputs (the JAX
kernel's test bound).
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) FLOP/s,
# and int32 operations/s: 64 INT32 lanes per SM against 128 f32 lanes,
# and the f32 rate counts an FMA as two operations, so a quarter of it;
# the tensor cores' dense TF32, bf16 FLOP/s and int8 operations/s. An
# f32-accurate product on the tensor cores takes three TF32 products
# (3xTF32), so f32 work runs there at a third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT32_OP_PER_S = F32_FLOP_PER_S / 4
TF32_FLOP_PER_S = 495e12
F32_3XTF32_FLOP_PER_S = TF32_FLOP_PER_S / 3
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
# __popc per SM per clock on compute capability 9.0 (CUDA programming
# guide, arithmetic instruction throughput), at the H100 SXM's 1.98 GHz
POPC_PER_S = 16 * 132 * 1.98e9
# integer-pipe instructions of one Rademacher hash in the sm_90a code of
# the LSH kernels (`cuobjdump -sass` of build/repro_torch/lsh_projection-*.so:
# 3 LOP3 and 2 SHF per (p, bit); the multiplies run as VIADD / IMAD on the
# FMA pipe). The source's 8 operations overstated the bound: the kernel
# ran under it at P = 4.19e9.
HASH_OPS = 5
STREAMED_EXCHANGE_NAMES = ("exchange_stats_kernel", "exchange_merge_kernel",
                           "exchange_mask_kernel", "exchange_target_kernel")


def streamed_exchange_names(exchange, m, n, r, c):
    """The streamed wrapper's kernels at an (M, N, R, C) call, as its
    `streamed_plan` says: the merge kernel where rows have many chunks
    (`merged`), the target kernel unless the mask launch writes the
    target (`fused`). A checkout without that plan launches stats, mask
    and target."""
    plan = getattr(exchange, "streamed_plan", None)
    if plan is None:
        return tuple(k for k in STREAMED_EXCHANGE_NAMES if "merge" not in k)
    p = plan(m, n, r, c)
    return tuple(k for k in STREAMED_EXCHANGE_NAMES
                 if ("merge" not in k or p["merged"])
                 and ("target" not in k or not p["fused"]))


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, names=(), iters: int = 20, per_call: int = 1):
    """Device time per call of fn() in ms, from torch.profiler. With
    `names` (a wrapper's kernels, each launched `per_call` times per
    call): the sum over names of the median duration of the kernels
    whose name contains it, times `per_call`, which a dropped activity
    record does not bias (in one H100 run
    the summed records of 20 calls of a 15 ms kernel came to a third of
    the CUDA-event time). Without: all device activity of the `iters`
    calls, summed, per call. None when the profiler records no such
    activity."""
    fn()
    dev = profiled_device_events(fn, iters)
    if names:
        per_name = [[e.time_range.elapsed_us() for e in dev if n in e.name]
                    for n in names]
        if not all(per_name):
            return None
        return per_call * sum(statistics.median(d) for d in per_name) / 1e3
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / iters / 1e3


def library_device_ms(fn, iters: int = 20):
    """Device time per call of one library call in ms: for each kernel
    name it launches, the median duration times the launches per call
    (rounded, at least 1). A library call launches a few fixed kernels,
    so medians keep dropped activity records from biasing the time (in
    one H100 run the profiler kept half of SDPA's records). None when
    the profiler records no device activity."""
    from collections import defaultdict
    fn()
    per_name = defaultdict(list)
    for e in profiled_device_events(fn, iters):
        per_name[e.name].append(e.time_range.elapsed_us())
    if not per_name:
        return None
    return sum(statistics.median(d) * max(1, round(len(d) / iters))
               for d in per_name.values()) / 1e3


def profiled_device_events(fn, iters: int):
    """The device activity of `iters` calls of fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if is_device_work(e, DeviceType)]


def is_device_work(e, DeviceType) -> bool:
    """A profiler event of device activity (kernel, copy, set), not the
    device-side image of a host `record_function` span."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("wpfed."))


def timings(kernel_fn, kernel_names, plain_fn, library_fn=None,
            plain_iters: int = 20, per_call: int = 1):
    """kernel_ms: the kernel's own device time per call (CUDA events
    around the wrapper when the profiler sees no device activity);
    call_ms: CUDA events around one wrapper call, host overhead and
    input casts included; plain_ms: all device time per call of the
    plain version; library_ms: the library call's device time by kernel
    name (`library_device_ms`); each with its event-timed call_ms.
    `per_call`: launches of each kernel name per wrapper call. A profile
    that records none of the device work is taken once more; where the
    second records none either, the time is the call's CUDA-event time,
    and `<key>_by` says which ("profiler" or "events")."""
    out = {"call_ms": time_ms(kernel_fn),
           "plain_call_ms": time_ms(plain_fn, warmup=min(3, plain_iters),
                                    iters=plain_iters)}

    def by(key, profiled, events):
        ms = profiled() or profiled()
        out[key], out[key + "_by"] = ((ms, "profiler") if ms
                                      else (events, "events"))

    by("kernel_ms", lambda: device_ms(kernel_fn, kernel_names,
                                      per_call=per_call), out["call_ms"])
    by("plain_ms", lambda: device_ms(plain_fn, iters=plain_iters),
       out["plain_call_ms"])
    out["library_ms"] = None
    if library_fn is not None:
        out["library_call_ms"] = time_ms(library_fn)
        by("library_ms", lambda: library_device_ms(library_fn),
           out["library_call_ms"])
    return out


def bound(bytes_moved: float, ops_time_s: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    the operations' time at peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    if t_bytes >= ops_time_s:
        return t_bytes * 1e3, "bytes"
    return ops_time_s * 1e3, "operations"


LSH_NAMES = ("lsh_partial", "lsh_reduce")


def lsh_order(torch, x, k, bits, row_offset=0):
    """split_len, the instance the launch took (single / few / many rows,
    with its rows and bits per block), the groups of rows the batched
    wrapper launches one by one, and whether the kernel's sums equal
    the order twin's (at `row_offset`) bit for bit; raises when they do
    not."""
    from repro_torch.kernels import lsh_projection, ref
    m, p = x.shape
    chunk = lsh_projection.split_len(p)
    twin = ref.lsh_project_sums_split_order(x, 7, bits=bits, chunk=chunk,
                                            row_offset=row_offset)
    equal = bool(torch.equal(k.reshape(m, bits), twin))
    del twin
    if not equal:
        raise AssertionError(f"lsh kernel differs from the order twin at "
                             f"M={m}, P={p}, L={chunk}")
    choice = lsh_projection.launch_choice(m, p, bits)
    return {"split_len": chunk, **choice,
            "row_groups": len(lsh_projection.row_groups(m, p, bits)),
            "order_equal": equal}


def check_lsh(torch, m, p, bits, gen):
    from repro_torch.kernels import lsh_projection, ops, ref
    x = torch.randn((m, p), generator=gen, device="cuda") * 0.05
    # the call's own allocations: its output and the scratch of the plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k = lsh_projection.lsh_project_sums_batched(x, 7, bits=bits)
    call_peak_bytes = torch.cuda.max_memory_allocated() - base
    _, groups, shape = lsh_projection.split_plan(p, m, bits)
    planned = 4 * (math.prod(shape) + m * bits)
    if call_peak_bytes > planned + (1 << 20):
        raise AssertionError(f"lsh call allocated {call_peak_bytes} bytes, "
                             f"planned {planned}")
    pl = ref.lsh_project_sums_batched_ref(x, 7, bits=bits)
    torch.cuda.synchronize()
    scale = x.norm(dim=1, keepdim=True)
    err = (k - pl).abs()
    if not bool((err <= 1e-5 * (pl.abs() + scale)).all()):
        raise AssertionError(f"lsh sums disagree: max err {err.max().item()}")
    off_zero = pl.abs() > 1e-3
    if not torch.equal((k > 0)[off_zero], (pl > 0)[off_zero]):
        raise AssertionError("lsh code bits disagree off zero")
    order = lsh_order(torch, x, k, bits)
    n0 = lsh_projection.KERNEL.launches
    r = ops.rademacher_block(0, p, bits, 7, device="cuda")
    t = timings(lambda: lsh_projection.lsh_project_sums_batched(
                    x, 7, bits=bits),
                LSH_NAMES,
                lambda: ref.lsh_project_sums_batched_ref(x, 7, bits=bits),
                library_fn=lambda: torch.matmul(x, r), plain_iters=5,
                per_call=len(groups))
    del r
    # f32 FMAs and the integer hash run on separate pipes: the larger wins
    ops_s = max(lsh_projection.projection_flops(m, p, bits) / F32_FLOP_PER_S,
                HASH_OPS * p * bits / INT32_OP_PER_S)
    bms, by = bound(4.0 * m * p + 4.0 * m * bits, ops_s)
    return dict(**t, **order, max_abs_err=err.max().item(), bound_ms=bms,
                bound_by=by, call_peak_bytes=call_peak_bytes,
                launches=lsh_projection.KERNEL.launches - n0)


def selection_inputs(torch, m, bits, gen, ties, departed=0.0):
    """Random packed codes (M, W) int32 and Eq. 7-like scores on a
    4-value grid (ties across columns), or all-zero scores (round 0).
    `departed` > 0: that share of the scores (at least one) at -inf, the
    service's departed clients (`select_partners(active=)`)."""
    w = bits // 32
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, w), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    grid = torch.tensor([0.0, 0.25, 0.5, 1.0], device="cuda")
    scores = (torch.zeros(m, device="cuda") if ties else
              grid[torch.randint(0, 4, (m,), generator=gen, device="cuda")])
    return codes, depart(torch, scores, departed, gen)


def depart(torch, scores, share, gen):
    """`scores` with max(1, round(share * M)) random columns at -inf
    (none when share is 0)."""
    if share <= 0:
        return scores
    m = scores.shape[0]
    k = max(1, round(share * m))
    gone = torch.randperm(m, generator=gen, device="cuda")[:k]
    return scores.index_fill(0, gone, -math.inf)


def selection_bound(m, w, n):
    """Codes, scores, table and the (M, N) outputs once; the +-1 Gram's
    2*M*M*W*32 int8 operations at the tensor cores' dense rate (the
    kernels' route)."""
    nsel = min(n, m - 1)
    bytes_moved = 4.0 * (m * w + m + w * 32 + 1) + 8.0 * m * nsel
    return bound(bytes_moved, 2.0 * m * m * w * 32 / INT8_OP_PER_S)


def popc_bound_ms(m, w):
    """The XOR + popcount route's floor: M*M*W popcounts at 16 per SM per
    clock (POPC_PER_S)."""
    return m * m * w / POPC_PER_S * 1e3


def selection_facts(torch, selection, codes, scores, bits, n, got, call,
                    kernel_name):
    """What both exact selection checks print: the wrapper's launch plan
    (`selection.select_plan`, None in a checkout without one), a second
    launch bit-identical to `got` (else it raises), the popcount route's
    floor, and `torch._int_mm` on the unpacked +-1 codes as a Gram-only
    yardstick (`gram_library_ms`, never called by the port; where the
    (M, M) int32 product fits, M a multiple of 8, 1,024 <= M <= 16,384)."""
    from repro_torch.kernels import ref
    m, w = codes.shape
    again = call()
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"two {kernel_name} launches differ at m={m}, "
                             f"bits={bits}, n={n}")
    plan = getattr(selection, "select_plan", None)
    out = {"plan": plan(m, w, n) if plan else None, "repeat_bit_equal": True,
           "popc_bound_ms": popc_bound_ms(m, w), "gram_library_ms": None}
    if m % 8 == 0 and 1024 <= m <= 16_384:
        a = ref.unpack_pm1(codes).to(torch.int8)
        try:
            out["gram_library_ms"] = library_device_ms(
                lambda: torch._int_mm(a, a.t()))
        except RuntimeError as e:        # a yardstick only: record why not
            out["gram_library_error"] = str(e).splitlines()[0]
        del a
    return out


def max_finite_diff(a, b) -> float:
    diff = (a - b).abs()
    finite = diff[diff.isfinite()]
    return finite.max().item() if finite.numel() else 0.0


def selection_plain(ref, codes, scores, lut, n):
    """The plain version a selection check holds a kernel to:
    `fused_select_ref`, or past M = 8,192 `fused_select_tiled_ref` in
    4096 x 4096 tiles, so its temporaries stay at a few GB."""
    if codes.shape[0] > 8192:
        return lambda: ref.fused_select_tiled_ref(
            codes, scores, lut, num_neighbors=n, block_m=4096, block_k=4096)
    return lambda: ref.fused_select_ref(codes, scores, lut, num_neighbors=n)


def check_selection(torch, m, bits, n, gen, ties=False, departed=0.0):
    """The one-shot kernel against its plain version (`selection_plain`),
    launched twice (bit-identical, else it raises), with its plan; ids
    compared on every rank, the masked ones too (`departed`)."""
    from repro_torch.kernels import ref, selection
    codes, scores = selection_inputs(torch, m, bits, gen, ties, departed)
    call = lambda: selection.fused_select(          # noqa: E731
        codes, scores, bits=bits, gamma=1.0, num_neighbors=n)
    ki, kw = got = call()
    lut = ref.selection_lut(bits // 32, bits, 1.0, device=codes.device)
    plain = selection_plain(ref, codes, scores, lut, n)
    pi, pw = plain()
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and torch.equal(kw, pw)):
        raise AssertionError(f"selection disagrees at m={m}, bits={bits}")
    del pi
    facts = selection_facts(torch, selection, codes, scores, bits, n, got,
                            call, "fused_select_kernel")
    n0 = selection.KERNEL.launches
    t = timings(call, ("fused_select_kernel",), plain,
                plain_iters=1 if m > 8192 else (3 if m >= 1024 else 20))
    bms, by = selection_bound(m, bits // 32, n)
    return dict(**t, **facts, max_abs_err=max_finite_diff(kw, pw),
                bound_ms=bms, bound_by=by,
                launches=selection.KERNEL.launches - n0)


def check_selection_tiled(torch, m, bits, n, gen, ties=False, departed=0.0):
    """The column-tiled kernel against `fused_select_tiled_ref` (4096 x
    4096 tiles past M = 8192, so the plain version's temporaries stay at
    a few GB), launched twice (bit-identical, else it raises), with its
    plan, and, up to M = 46,489, against the one-shot kernel, whose
    device time is recorded beside it (`oneshot_ms`)."""
    from repro_torch.kernels import ref, selection
    from repro_torch.kernels.build import MAX_SHARED_BYTES
    codes, scores = selection_inputs(torch, m, bits, gen, ties, departed)
    blocks = (dict(block_m=4096, block_k=4096) if m > 8192 else {})
    lut = ref.selection_lut(bits // 32, bits, 1.0, device=codes.device)
    call = lambda: selection.fused_select_tiled(    # noqa: E731
        codes, scores, bits=bits, gamma=1.0, num_neighbors=n)
    ki, kw = got = call()
    pi, pw = ref.fused_select_tiled_ref(codes, scores, lut, num_neighbors=n,
                                        **blocks)
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and torch.equal(kw, pw)):
        raise AssertionError(f"tiled selection disagrees with its plain "
                             f"version at m={m}, bits={bits}")
    facts = selection_facts(torch, selection, codes, scores, bits, n, got,
                            call, "select_tiled_kernel")
    out = {"oneshot_ms": None}
    if selection.oneshot_smem_bytes(m) <= MAX_SHARED_BYTES:
        oi, ow = selection.fused_select(codes, scores, bits=bits, gamma=1.0,
                                        num_neighbors=n)
        torch.cuda.synchronize()
        if not (torch.equal(ki, oi) and torch.equal(kw, ow)):
            raise AssertionError(f"tiled selection disagrees with the "
                                 f"one-shot kernel at m={m}, bits={bits}")
        out["oneshot_ms"] = device_ms(lambda: selection.fused_select(
            codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
            ("fused_select_kernel",))
    n0 = selection.TILED_KERNEL.launches
    t = timings(lambda: selection.fused_select_tiled(
                    codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
                ("select_tiled_kernel",),
                lambda: ref.fused_select_tiled_ref(
                    codes, scores, lut, num_neighbors=n, **blocks),
                plain_iters=1 if m > 8192 else (3 if m >= 1024 else 20))
    bms, by = selection_bound(m, bits // 32, n)
    return dict(**t, **out, **facts, max_abs_err=max_finite_diff(kw, pw),
                bound_ms=bms, bound_by=by,
                launches=selection.TILED_KERNEL.launches - n0)


def exchange_inputs(torch, m, n, r, c, gen, all_selected, masked=False):
    """Logits, labels and a selection mask: all selected, a random 70 %,
    or `masked` (the service's rows under churn): every third row all
    masked (no valid neighbour, has_target False), every third only rank
    0 selected (N-1 of N masked), the rest a random 70 %."""
    own = torch.randn((m, r, c), generator=gen, device="cuda") * 3
    nb = torch.randn((m, n, r, c), generator=gen, device="cuda") * 3
    y = torch.randint(0, c, (m, r), generator=gen, device="cuda")
    sel = (torch.ones((m, n), dtype=torch.bool, device="cuda")
           if all_selected else
           torch.rand((m, n), generator=gen, device="cuda") < 0.7)
    if masked:
        rows = torch.arange(m, device="cuda") % 3
        sel[rows == 0] = False
        sel[rows == 1] = False
        sel[rows == 1, 0] = True
    return own, nb, y, sel


def exchange_bound(m, n, r, c):
    """Own and neighbour logits, labels and selection read once, l_ij,
    valid, target and has_target written once; per neighbour element
    max, exp, sum, the KL term (exp, sub, mul, add) and the target add:
    ~10 f32 operations."""
    bytes_moved = (4.0 * (2 * m * r * c + m * n * r * c + m * r + m * n)
                   + m * n * 2 + m)
    return bound(bytes_moved, 10.0 * m * n * r * c / F32_FLOP_PER_S)


def same_bits(torch, a, b) -> bool:
    """Two exchange results equal bit for bit (NaN where NaN)."""
    return all(bool(torch.equal(x.nan_to_num(), z.nan_to_num())
                    and torch.equal(x.isnan(), z.isnan()))
               if x.is_floating_point() else bool(torch.equal(x, z))
               for x, z in zip(a, b))


def check_exchange(torch, m, n, r, c, gen, all_selected=False, masked=False):
    """The one-shot kernel against `all_in_one_exchange_ref`, launched
    twice (bit-identical, else it raises), with its launch plan
    (`exchange.oneshot_plan`) and the plain version's peak allocation."""
    from repro_torch.kernels import exchange, ref
    own, nb, y, sel = exchange_inputs(torch, m, n, r, c, gen, all_selected,
                                      masked)
    got = exchange.fused_exchange(own, nb, y, sel)
    kl, kv, kt, kh = got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pl, pv, pt, ph = ref.all_in_one_exchange_ref(own, nb, y, sel)
    torch.cuda.synchronize()
    plain_peak_bytes = torch.cuda.max_memory_allocated() - base
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    if not (torch.equal(kv, pv) and torch.equal(kh, ph)):
        raise AssertionError(f"exchange masks disagree at {(m, n, r, c)}")
    err = max((kl - pl).abs().max().item(), (kt - pt).abs().max().item())
    del pl, pv, pt, ph
    if not same_bits(torch, got, exchange.fused_exchange(own, nb, y, sel)):
        raise AssertionError(f"two exchange launches differ at "
                             f"{(m, n, r, c)}")
    n0 = exchange.KERNEL.launches
    t = timings(lambda: exchange.fused_exchange(own, nb, y, sel),
                ("fused_exchange_kernel",),
                lambda: ref.all_in_one_exchange_ref(own, nb, y, sel),
                plain_iters=3 if m >= 4096 else 20)
    bms, by = exchange_bound(m, n, r, c)
    return dict(**t, plan=exchange.oneshot_plan(m, n, r, c),
                repeat_bit_equal=True, plain_peak_bytes=plain_peak_bytes,
                max_abs_err=err, bound_ms=bms, bound_by=by,
                launches=exchange.KERNEL.launches - n0)


def check_exchange_streamed(torch, m, n, r, c, gen, all_selected=False,
                            masked=False):
    """The streamed kernel against `streamed_exchange_ref` and
    `all_in_one_exchange_ref`; the one-shot kernel's device time at the
    same inputs is recorded beside it (`oneshot_ms`)."""
    from repro_torch.kernels import exchange, ref
    own, nb, y, sel = exchange_inputs(torch, m, n, r, c, gen, all_selected,
                                      masked)
    got = exchange.fused_exchange_streamed(own, nb, y, sel)
    kl, kv, kt, kh = got
    err = 0.0
    for plain in (ref.streamed_exchange_ref, ref.all_in_one_exchange_ref):
        pl, pv, pt, ph = plain(own, nb, y, sel)
        torch.cuda.synchronize()
        torch.testing.assert_close(kl, pl, rtol=2e-5, atol=1e-5)
        torch.testing.assert_close(kt, pt, rtol=2e-5, atol=1e-5)
        if not (torch.equal(kv, pv) and torch.equal(kh, ph)):
            raise AssertionError(f"streamed exchange masks disagree with "
                                 f"{plain.__name__} at {(m, n, r, c)}")
        err = max(err, (kl - pl).abs().max().item(),
                  (kt - pt).abs().max().item())
        del pl, pv, pt, ph
    if not same_bits(torch, got,
                     exchange.fused_exchange_streamed(own, nb, y, sel)):
        raise AssertionError(f"two streamed exchange launches differ at "
                             f"{(m, n, r, c)}")
    oneshot_ms = device_ms(lambda: exchange.fused_exchange(own, nb, y, sel),
                           ("fused_exchange_kernel",))
    n0 = exchange.STREAMED_KERNEL.launches
    t = timings(lambda: exchange.fused_exchange_streamed(own, nb, y, sel),
                streamed_exchange_names(exchange, m, n, r, c),
                lambda: ref.streamed_exchange_ref(own, nb, y, sel),
                plain_iters=2 if c > 8192 else 20)
    bms, by = exchange_bound(m, n, r, c)
    return dict(**t, oneshot_ms=oneshot_ms,
                plan=exchange.streamed_plan(m, n, r, c),
                repeat_bit_equal=True,
                two_read_floor_ms=bms + 1e3 * 4.0 * m * n * r * c
                / HBM_BYTES_PER_S,
                max_abs_err=err, bound_ms=bms, bound_by=by,
                launches=exchange.STREAMED_KERNEL.launches - n0)


def clustered_codes(torch, m, bits, gen, per_cluster=32, flip=0.02):
    """Codes of a converging federation: cluster centres of `per_cluster`
    clients each, every client's bits flipped with probability `flip`
    (the JAX ANN tests' regime), and Eq. 7-like scores concentrated in
    [0.75, 1] (distance-dominated Eq. 8)."""
    from repro_torch.kernels import ops
    centers = torch.rand((max(m // per_cluster, 1), bits), generator=gen,
                         device="cuda") < 0.5
    assign = torch.randint(0, centers.shape[0], (m,), generator=gen,
                           device="cuda")
    flips = torch.rand((m, bits), generator=gen, device="cuda") < flip
    codes = ops.pack_bits((centers[assign] ^ flips).float() * 2 - 1)
    scores = 0.75 + 0.25 * torch.rand(m, generator=gen, device="cuda")
    return codes, scores


def ann_inputs(torch, m, bits, n, gen, kind, prefix_bits=10, probes=8,
               departed=0.0):
    """Codes, scores and the `ann_candidates` of one selection (seed 0):
    kind "random" (gridded scores), "ties" (all scores 0, round 0) or
    "clustered"; `departed` as in `selection_inputs`."""
    from repro_torch.core import ann
    if kind == "clustered":
        codes, scores = clustered_codes(torch, m, bits, gen)
        scores = depart(torch, scores, departed, gen)
    else:
        codes, scores = selection_inputs(torch, m, bits, gen,
                                         ties=kind == "ties",
                                         departed=departed)
    cand = ann.ann_candidates(codes, scores, seed=0, prefix_bits=prefix_bits,
                              probes=probes, num_neighbors=min(n, m - 1))
    return codes, scores, cand


def check_selection_ann(torch, m, bits, n, gen, kind="random",
                        prefix_bits=10, probes=8):
    """The per-row ANN function (the grouped entry point's one-row
    instance on `ann.per_row_slots`, kernel `select_ann_rows_kernel`)
    against `ann_select_ref` on the same candidates, with its plan; with
    prefix_bits=0 also against the one-shot exact kernel, whose device
    time is recorded beside it (`oneshot_ms`). Bounded as the grouped
    route on the one-slot lists (`ann_grouped_bound`)."""
    from repro_torch.core import ann
    from repro_torch.kernels import ref, selection
    codes, scores, cand = ann_inputs(torch, m, bits, n, gen, kind,
                                     prefix_bits, probes)
    lut = ref.selection_lut(bits // 32, bits, 1.0, device=codes.device)
    call = lambda: selection.fused_select_ann(     # noqa: E731
        codes, scores, cand.ids, bits=bits, gamma=1.0, num_neighbors=n)
    plain = lambda: ref.ann_select_ref(            # noqa: E731
        codes, scores, cand.ids, lut, num_neighbors=n)
    ki, kw = call()
    pi, pw = plain()
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and torch.equal(kw, pw)):
        raise AssertionError(f"ANN selection disagrees with its plain "
                             f"version at m={m}, kind={kind}")
    k = cand.ids.shape[1]
    out = {"k": k, "oneshot_ms": None, "plan": selection.ann_plan(
        m, bits // 32, n, k, m, one_row_slots=True)}
    if prefix_bits == 0:
        oi, ow = selection.fused_select(codes, scores, bits=bits, gamma=1.0,
                                        num_neighbors=n)
        torch.cuda.synchronize()
        if not (torch.equal(ki, oi) and torch.equal(kw, ow)):
            raise AssertionError(f"ANN selection with prefix_bits=0 differs "
                                 f"from the one-shot kernel at m={m}")
        out["oneshot_ms"] = device_ms(lambda: selection.fused_select(
            codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
            ("fused_select_kernel",))
    n0 = selection.ANN_KERNEL.launches
    t = timings(call, ("select_ann_rows_kernel",), plain,
                plain_iters=1 if m > 8192 else (3 if m >= 1024 else 20))
    bms, by, pairs = ann_grouped_bound(ann.per_row_slots(cand.ids, m), codes,
                                       n)
    return dict(**t, **out, pairs=pairs, max_abs_err=max_finite_diff(kw, pw),
                bound_ms=bms, bound_by=by,
                launches=selection.ANN_KERNEL.launches - n0)


def ann_grouped_bound(cand, codes, n):
    """Codes, scores, table, the S x K lists, `order` and `starts` read
    once, the (M, N) outputs written once; the +-1 Gram's 2*W*32 int8
    operations per pair of a client and a candidate of its slot's list
    (sentinels and the client itself excluded), counted on this run's
    lists, at the tensor cores' dense rate (the kernel's route)."""
    import torch
    m, w = codes.shape
    s, k = cand.lists.shape
    nsel = min(n, m - 1)
    per_slot = (cand.starts[1:] - cand.starts[:-1]).to(torch.int64)
    valid = (cand.lists < m).sum(1).to(torch.int64)
    rows = torch.arange(m, device=codes.device)
    own = (cand.lists[cand.slot.long()] == rows[:, None]).sum()
    pairs = int((per_slot * valid).sum() - own)
    bytes_moved = (4.0 * (m * w + m + w * 32 + 1 + s * k + m + s + 1)
                   + 8.0 * m * nsel)
    return bound(bytes_moved, 2.0 * pairs * w * 32 / INT8_OP_PER_S) + (
        pairs,)


def check_selection_ann_grouped(torch, m, bits, n, gen, kind="random",
                                prefix_bits=10, probes=8, departed=0.0):
    """The grouped ANN kernel on `bucket_candidates` against its plain
    version (`ann_select_grouped_ref`) and the per-row function on
    `ann_candidates` of the same codes, launched twice (bit-identical,
    else it raises), with its plan; with prefix_bits=0 also against the
    one-shot exact kernel. The inputs are `ann_inputs`' (the same draws
    as the per-row check's)."""
    from repro_torch.core import ann
    from repro_torch.kernels import ref, selection
    codes, scores, rows = ann_inputs(torch, m, bits, n, gen, kind,
                                     prefix_bits, probes, departed)
    cand = ann.bucket_candidates(codes, scores, seed=0,
                                 prefix_bits=prefix_bits, probes=probes,
                                 num_neighbors=min(n, m - 1))
    lut = ref.selection_lut(bits // 32, bits, 1.0, device=codes.device)
    call = lambda: selection.fused_select_ann_grouped(  # noqa: E731
        codes, scores, cand, bits=bits, gamma=1.0, num_neighbors=n)
    plain = lambda: ref.ann_select_grouped_ref(    # noqa: E731
        codes, scores, cand, lut, num_neighbors=n)
    ki, kw = got = call()
    pi, pw = plain()
    ri, rw = selection.fused_select_ann(codes, scores, rows.ids, bits=bits,
                                        gamma=1.0, num_neighbors=n)
    again = call()
    torch.cuda.synchronize()
    if not torch.equal(cand.lists[cand.slot.long()], rows.ids):
        raise AssertionError(f"bucket lists differ from ann_candidates at "
                             f"m={m}, kind={kind}")
    if not (torch.equal(ki, pi) and torch.equal(kw, pw)):
        raise AssertionError(f"grouped ANN selection disagrees with its "
                             f"plain version at m={m}, kind={kind}")
    if not (torch.equal(ki, ri) and torch.equal(kw, rw)):
        raise AssertionError(f"grouped ANN selection disagrees with the "
                             f"per-row function at m={m}, kind={kind}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"two grouped ANN launches differ at m={m}")
    s, k = cand.lists.shape
    out = {"k": k, "slots": s, "plan": selection.ann_plan(
               m, bits // 32, n, k, s), "repeat_bit_equal": True,
           "oneshot_ms": None, "per_row_ms": device_ms(
               lambda: selection.fused_select_ann(
                   codes, scores, rows.ids, bits=bits, gamma=1.0,
                   num_neighbors=n), ("select_ann_rows_kernel",))}
    if prefix_bits == 0:
        oi, ow = selection.fused_select(codes, scores, bits=bits, gamma=1.0,
                                        num_neighbors=n)
        torch.cuda.synchronize()
        if not (torch.equal(ki, oi) and torch.equal(kw, ow)):
            raise AssertionError(f"grouped ANN selection with prefix_bits=0 "
                                 f"differs from the one-shot kernel at m={m}")
        out["oneshot_ms"] = device_ms(lambda: selection.fused_select(
            codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
            ("fused_select_kernel",))
    del rows
    n0 = selection.GROUPED_KERNEL.launches
    t = timings(call, ("select_ann_grouped_kernel",), plain,
                plain_iters=1 if m > 8192 else (3 if m >= 1024 else 20))
    bms, by, pairs = ann_grouped_bound(cand, codes, n)
    return dict(**t, **out, pairs=pairs, max_abs_err=max_finite_diff(kw, pw),
                bound_ms=bms, bound_by=by,
                launches=selection.GROUPED_KERNEL.launches - n0)


def check_lsh_single(torch, p, bits, gen, row_offset=0):
    """The single-client kernel against its plain version and the order
    twin, both at `row_offset` (x a shard whose hash rows start there,
    mod 2^32), and at offset 0 its sums against the batched kernel's row
    on the same vector (`batched_equal`: bit for bit)."""
    from repro_torch.kernels import lsh_projection, ops, ref
    x = torch.randn((p,), generator=gen, device="cuda") * 0.05
    kw = dict(bits=bits, row_offset=row_offset)
    k = lsh_projection.lsh_project_sums(x, 7, **kw)
    pl = ref.lsh_project_sums_ref(x, 7, **kw)
    row = lsh_projection.lsh_project_sums_batched(x[None], 7, bits=bits)[0]
    torch.cuda.synchronize()
    err = (k - pl).abs()
    if not bool((err <= 1e-5 * (pl.abs() + x.norm())).all()):
        raise AssertionError(f"lsh_single sums disagree at row offset "
                             f"{row_offset}: max err {err.max().item()}")
    off_zero = pl.abs() > 1e-3
    if not torch.equal((k > 0)[off_zero], (pl > 0)[off_zero]):
        raise AssertionError(f"lsh_single code bits disagree off zero at "
                             f"row offset {row_offset}")
    order = lsh_order(torch, x[None], k, bits, row_offset=row_offset)
    n0 = lsh_projection.SINGLE_KERNEL.launches
    r = ops.rademacher_block(row_offset, p, bits, 7, device="cuda")
    t = timings(lambda: lsh_projection.lsh_project_sums(x, 7, **kw),
                LSH_NAMES,
                lambda: ref.lsh_project_sums_ref(x, 7, **kw),
                library_fn=lambda: torch.matmul(x, r), plain_iters=5)
    del r
    ops_s = max(2.0 * p * bits / F32_FLOP_PER_S,
                HASH_OPS * p * bits / INT32_OP_PER_S)
    bms, by = bound(4.0 * p + 4.0 * bits, ops_s)
    if row_offset == 0 and not torch.equal(k, row):
        raise AssertionError("lsh_single sums differ from the batched row")
    return dict(**t, **order, max_abs_err=err.max().item(), bound_ms=bms,
                bound_by=by, batched_equal=True if row_offset == 0 else None,
                launches=lsh_projection.SINGLE_KERNEL.launches - n0)


def check_hamming(torch, m, bits, gen):
    """All pairs of one code set, as `lsh.distance_matrix` computes them,
    against the plain version; `library_ms` is torch.cdist(p=0) on the
    unpacked bits as float (counts the differing bits; unpacking not
    timed). `path` is the launch's path (small or tiled, chosen by M*N
    in the C entry point); `popc_floor_ms` the M*M*W popcounts at 16 per
    SM per clock."""
    from repro_torch.kernels import hamming, ops, ref
    w = bits // 32
    path = hamming.launch_path(m, m)
    codes, _ = selection_inputs(torch, m, bits, gen, ties=True)
    codes[1] = codes[0]
    k = hamming.hamming_all_pairs(codes, codes)
    pl = ref.hamming_all_pairs_ref(codes, codes)
    torch.cuda.synchronize()
    if not torch.equal(k, pl):
        raise AssertionError(f"hamming disagrees at m={m}, bits={bits}")
    del k, pl
    unpacked = ops.unpack_bits(codes, bits).float()
    n0 = hamming.KERNEL.launches
    t = timings(lambda: hamming.hamming_all_pairs(codes, codes),
                (f"hamming_{path}_kernel",),
                lambda: ref.hamming_all_pairs_ref(codes, codes),
                library_fn=lambda: torch.cdist(unpacked, unpacked, p=0),
                plain_iters=2 if m > 8192 else 20)
    bms, by = bound(4.0 * (2 * m * w + m * m), 3.0 * m * m * w
                    / INT32_OP_PER_S)
    return dict(**t, max_abs_err=0.0, bound_ms=bms, bound_by=by,
                popc_floor_ms=m * m * w / POPC_PER_S * 1e3, path=path,
                launches=hamming.KERNEL.launches - n0)


def flash_plan_summary(flash_attention, b, sq, sk, h, kvh, dh, dtype,
                       causal):
    """The launch plan of a flash call (`flash_attention.flash_plan`) on
    this card's SMs, as the kernel reads their count: configuration,
    items, blocks (grid) and shared memory per block."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = flash_attention.flash_plan(b, sq, sk, h, kvh, dh, dtype, causal,
                                      sms)
    return {k: plan[k] for k in ("config", "items", "rows_per_item", "bk",
                                 "grid", "blocks_per_sm", "smem_bytes")}


def check_flash(torch, n, sq, sk, dh, causal, dtype, gen, heads=None):
    """The flash-attention kernel against its plain version on unit-normal
    (N, S, dh) inputs, or with `heads` = (H, KV) on the model's (B, S, H,
    dh) / (B, S, KV, dh) layout through `ops.gqa_flash_attention` (N = B
    then). `library_ms`: torch's scaled_dot_product_attention on the same
    tensors, as a (1, N, S, dh) view (for the GQA layout heads moved next
    to the batch, KV heads repeated); `library_max_abs_err` its distance
    from the plain version. Bound: q, k, v and out once; 4 * N * H *
    pairs * dh operations on the kernel's route, the tensor cores: f32 by
    3xTF32 at a third of the TF32 rate, bf16 at the bf16 rate
    (`cuda_core_bound_ms`: the same operations at the f32 CUDA-core
    rate, the bound of the earlier CUDA-core kernel)."""
    from repro_torch.kernels import flash_attention, ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if heads is None:
        q, k, v = (torch.randn((n, s, dh), generator=gen, device="cuda")
                   .to(dtype) for s in (sq, sk, sk))
        call = lambda: flash_attention.flash_attention(  # noqa: E731
            q, k, v, causal=causal)
        plain = lambda: ref.flash_attention_ref(          # noqa: E731
            q, k, v, causal=causal)
        # the (1, N, S, dh) view: on 3-D tensors SDPA takes its math path
        lib = lambda: sdpa(q[None], k[None], v[None],     # noqa: E731
                           is_causal=causal)[0]
        h, kvh = 1, 1
    else:
        h, kvh = heads
        q = torch.randn((n, sq, h, dh), generator=gen, device="cuda")
        k, v = (torch.randn((n, sk, kvh, dh), generator=gen, device="cuda")
                for _ in range(2))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        call = lambda: ops.gqa_flash_attention(           # noqa: E731
            q, k, v, causal=causal)
        plain = lambda: ops.gqa_flash_attention(          # noqa: E731
            q, k, v, causal=causal, use_kernel=False)
        qh = q.movedim(2, 1)
        kh, vh = (t.movedim(2, 1).repeat_interleave(h // kvh, dim=1)
                  for t in (k, v))
        lib = lambda: sdpa(                               # noqa: E731
            qh, kh, vh, is_causal=causal).movedim(1, 2)
    o, pl, lo = call(), plain(), lib()
    torch.cuda.synchronize()
    err = (o.float() - pl.float()).abs().max().item()
    lib_err = (lo.float() - pl.float()).abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    if not err < tol:
        raise AssertionError(f"flash attention disagrees at "
                             f"{(n, sq, sk, dh, causal, dtype, heads)}: "
                             f"max abs err {err}")
    del o, pl, lo
    n0 = flash_attention.KERNEL.launches
    t = timings(call, ("flash_fwd_kernel",), plain, library_fn=lib)
    size = q.element_size()
    flop = float(flash_attention.attention_flops(n, h, sq, sk, dh, causal))
    rate = F32_3XTF32_FLOP_PER_S if dtype == torch.float32 \
        else BF16_FLOP_PER_S
    bms, by = bound(size * (2.0 * q.numel() + 2.0 * k.numel()), flop / rate)
    return dict(**t, max_abs_err=err, library_max_abs_err=lib_err,
                bound_ms=bms, bound_by=by,
                cuda_core_bound_ms=flop / F32_FLOP_PER_S * 1e3,
                launches=flash_attention.KERNEL.launches - n0,
                plan=flash_plan_summary(flash_attention, n, sq, sk, h, kvh,
                                        dh, dtype, causal))


def check_flash_vmapped(torch, outer, b, s, h, kvh, dh, dtype, gen):
    """The flash kernel through its vmap rule, as the federation's
    neighbour web calls it: a nested vmap over `outer` = (clients,
    neighbours) of the GQA wrapper on (B, S, H, dh) queries and (B, S,
    KV, dh) keys and values, causal, one launch on the folded batch of
    prod(outer) * B sequences; against the plain version on that folded
    batch (2e-5 in f32, 2e-2 in bf16). `library_ms`: SDPA on the folded
    tensors, heads next to the batch, KV heads repeated. Bound as
    `check_flash`'s."""
    from torch.func import vmap

    from repro_torch.kernels import flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn((*outer, b, s, h, dh), generator=gen, device="cuda")
    k, v = (torch.randn((*outer, b, s, kvh, dh), generator=gen,
                        device="cuda") for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    nb = math.prod(outer) * b
    fq, fk, fv = (t.reshape(nb, *t.shape[len(outer) + 1:])
                  for t in (q, k, v))
    fn = lambda a, b_, c: flash_attention.gqa_attention(  # noqa: E731
        a, b_, c, causal=True)
    for _ in outer:
        fn = vmap(fn)

    def call():
        with torch.no_grad():
            return fn(q, k, v)

    plain = lambda: flash_attention.plain_gqa_attention(  # noqa: E731
        fq, fk, fv, True, 0.0)
    qh = fq.movedim(2, 1)
    kh, vh = (t.movedim(2, 1).repeat_interleave(h // kvh, dim=1)
              for t in (fk, fv))
    lib = lambda: sdpa(qh, kh, vh, is_causal=True)  # noqa: E731
    n0 = flash_attention.KERNEL.launches
    o = call()
    launches = flash_attention.KERNEL.launches - n0
    pl = plain()
    torch.cuda.synchronize()
    err = (o.reshape(pl.shape).float() - pl.float()).abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    if launches != 1 or not err < tol:
        raise AssertionError(f"vmapped flash at {outer} x {(b, s, h, kvh, dh)}"
                             f" {dtype}: {launches} launches, max abs err "
                             f"{err}")
    del o, pl
    t = timings(call, ("flash_fwd_kernel",), plain, library_fn=lib,
                plain_iters=5)
    flop = float(flash_attention.attention_flops(nb, h, s, s, dh, True))
    rate = F32_3XTF32_FLOP_PER_S if dtype == torch.float32 \
        else BF16_FLOP_PER_S
    bms, by = bound(q.element_size() * (2.0 * q.numel() + 2.0 * k.numel()),
                    flop / rate)
    return dict(**t, max_abs_err=err, bound_ms=bms, bound_by=by,
                launches=launches, folded_b=nb,
                plan=flash_plan_summary(flash_attention, nb, s, s, h, kvh,
                                        dh, dtype, True))


def flash_vmap_contract_and_taint(torch):
    """The flash contract point (f32, `kernel_contract`'s make_args) under
    a vmap over two copies, within the contract's atol of its twin on
    the card, and the taint check on that vmapped call: the wrapper rule
    fires once, with one launch, and the output carries exactly the
    inputs' labels."""
    from torch.func import vmap

    from repro_torch.analysis import taint
    from repro_torch.analysis.registry import REGISTRY
    from repro_torch.kernels import flash_attention
    entry = REGISTRY["flash_attention"]
    args, kwargs = entry.make_args(entry.points[0])
    q, k, v = (torch.stack([t, t.flip(0)]).cuda() for t in args)

    def fn(q, k, v):
        with torch.no_grad():
            return vmap(lambda a, b, c: flash_attention.gqa_attention(
                a, b, c, **kwargs))(q, k, v)

    n0 = flash_attention.KERNEL.launches
    run = taint.run_labelled("flash-vmap", fn, (q, k, v),
                             (taint.SRC_PARAMS, taint.SRC_DATA, ""))
    launches = flash_attention.KERNEL.launches - n0
    want = torch.stack([entry.twin_call((q[i], k[i], v[i]), kwargs)
                        for i in range(2)])
    err = (run.out - want).abs().max().item() if run.out is not None \
        else None
    labels = sorted(run.engine.of(run.out)) if run.out is not None else []
    ok = (not run.findings and launches == 1 and err is not None
          and err <= entry.atol and run.engine.kernels == {"flash_attention"}
          and labels == sorted([taint.SRC_PARAMS, taint.SRC_DATA]))
    if not ok:
        raise AssertionError(f"vmapped flash contract / taint: findings "
                             f"{[str(f) for f in run.findings]}, launches "
                             f"{launches}, err {err}, rules "
                             f"{run.engine.kernels}, labels {labels}")
    return {"launches": launches, "max_abs_err": err, "atol": entry.atol,
            "wrapper_rules": sorted(run.engine.kernels), "labels": labels}


GEMM_NAMES = re.compile(r"gemm|xmma|cutlass|cublas", re.IGNORECASE)


def profile_steps(torch, fn, iters: int = 3):
    """fn() `iters` times under torch.profiler after one warm-up call:
    host ms per call (device synchronised), device busy ms per call,
    idle share, device launches per call, the device ms of the matrix
    products (kernels named like cuBLAS / CUTLASS GEMMs) and the five
    costliest device kernels (ms per call). Only the device's activity is
    recorded, and read from the profiler's raw results: recording the
    host's ops as well stretched a recurrentgemma-2b train step from the
    0.81 s it took unprofiled in the same run to 0.98 s (the device busy
    0.78 s), and turning the 6 x 10^5 launches of an xlstm-350m step and
    their host ops into FunctionEvents took minutes."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name = Counter()
    dev = [(e.name(), e.duration_ns() / 1e6)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation()
           and not e.name().startswith("wpfed.")]
    for name, ms in dev:
        by_name[name[:80]] += ms / iters
    busy = sum(by_name.values())
    gemm = sum(ms for name, ms in by_name.items() if GEMM_NAMES.search(name))
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_launches": len(dev) / iters,
            "gemm_device_ms": gemm,
            "top_device_ms": by_name.most_common(5)}


def same_tokens(torch, res, ref_run, label):
    """Two serving runs on the same weights and prompts: prefill logits
    within rtol 1e-4, atol 1e-4, and the same tokens except from a step
    where `ref_run`'s two largest logits lie within 1e-3. Returns (max
    abs prefill-logit difference, first differing step, first near-tie
    step); raises on a disagreement."""
    a, b = res["logits"][0].cpu(), ref_run["logits"][0].cpu()
    lg_err = (a - b).abs().max().item()
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    top2 = ref_run["logits"].topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1] <= 1e-3).any(dim=1)   # per step
    differ = (res["generated"] != ref_run["generated"]).any(axis=0)
    first_near = int(near.nonzero()[0]) if bool(near.any()) else None
    first_diff = int(differ.nonzero()[0][0]) if differ.any() else None
    if first_diff is not None and (first_near is None
                                   or first_diff < first_near):
        raise AssertionError(f"served tokens differ from the {label} run at "
                             f"step {first_diff} (first near-tie: "
                             f"{first_near})")
    return lg_err, first_diff, first_near


def serve_path(torch, kernels):
    """Path 4: Minitron-4B served at full width on the card, through the
    flash-attention kernel and then, on the same weights, through the
    naive attention; returns the kernel run's launch counts."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention
    from repro_torch.train import make_prefill_step, make_serve_step
    arch, kw = "minitron-4b", dict(reduced=False, batch=4, prompt_len=2048,
                                   max_new=32, seed=0, device="cuda")
    cfg = get_config(arch)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve(arch, **kw)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "main_path_launches", "run": "serve", **launches})
    if launches["flash_attention"] != cfg.num_layers or \
            any(v for name, v in launches.items()
                if name != "flash_attention"):
        raise AssertionError(f"the serving path must launch flash_attention "
                             f"{cfg.num_layers} times and nothing else: "
                             f"{launches}")
    logits, gen = res["logits"], res["generated"]
    if not (bool(logits.isfinite().all()) and gen.shape == (4, 32)
            and logits.shape == (32, 4, cfg.vocab_size)):
        raise AssertionError("serve gave non-finite logits or wrong shapes")

    for k in kernels.values():
        k.launches = 0
    attention.set_attn_impl("naive")
    try:
        naive = serve(arch, params=res["params"], **kw)
    finally:
        attention.set_attn_impl("auto")
    if kernels["flash_attention"].launches != 0:
        raise AssertionError("the naive run launched the kernel")
    lg_err, first_diff, first_near = same_tokens(torch, res, naive, "naive")

    # the kernel's device time in one profiled prefill, then decode steps
    prompts = {"tokens": torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 2048)), device="cuda")}
    step = make_prefill_step(cfg, cache_len=2048 + 32)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        _, cache = step(res["params"], prompts)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if is_device_work(e, DeviceType)]
    flash = [e.time_range.elapsed_us() / 1e3 for e in dev
             if "flash_fwd_kernel" in e.name]
    serve_step = make_serve_step(cfg)
    tok = torch.as_tensor(gen[:, 0], device="cuda")
    with torch.no_grad():
        decode = profile_steps(torch, lambda: serve_step(
            res["params"], cache, tok, 2048))
    emit({"phase": "serve", "arch": arch, "num_layers": cfg.num_layers,
          "d_model": cfg.d_model, "batch": 4, "prompt_len": 2048,
          "max_new": 32, "prefill_s": res["prefill_s"],
          "decode_tok_per_s": res["decode_tok_per_s"],
          "naive_prefill_s": naive["prefill_s"],
          "naive_decode_tok_per_s": naive["decode_tok_per_s"],
          "peak_memory_bytes": peak,
          "prefill_logits_max_abs_diff_vs_naive": lg_err,
          "tokens_equal_to_naive": first_diff is None,
          "first_differing_step": first_diff,
          "first_naive_near_tie_step": first_near,
          "flash_device_ms_in_prefill": sum(flash),
          "flash_launches_in_profile": len(flash),
          "prefill_device_ms": sum(e.time_range.elapsed_us() for e in dev)
          / 1e3,
          "decode_step_profile": decode,
          "sample": gen[0][:8].tolist()})
    return launches


# (arch, layers run (0: all), prompt_len, flash launches per prefill: one
# per "A" layer, bidir and causal; "X" takes the naive cross route and
# "L" the window route, "R"/"S"/"M" no attention)
FAMILIES = (("grok-1-314b", 2, 2048, 2),
            ("llama-3.2-vision-90b", 5, 2048, 4),
            ("recurrentgemma-2b", 0, 2048, 0),
            ("xlstm-350m", 0, 2048, 0),
            ("whisper-small", 0, 448, 24))


def greedy(torch, cfg, params, prompts, max_new):
    """`launch.serve.serve`'s prefill and greedy decode on an explicit
    config (the reduced configs held card against CPU, kimi-k2's widened
    to 16 experts among them)."""
    from repro_torch.train import make_prefill_step, make_serve_step
    s = prompts["tokens"].shape[1]
    prefill_step = make_prefill_step(cfg, cache_len=s + max_new)
    serve_step = make_serve_step(cfg)
    with torch.no_grad():
        logits, cache = prefill_step(params, prompts)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out, seen = [tok], [logits]
        for i in range(max_new - 1):
            tok, logits, cache = serve_step(params, cache, tok, s + i)
            out.append(tok)
            seen.append(logits)
    return {"generated": torch.stack(out, dim=1).cpu().numpy(),
            "logits": torch.stack(seen).cpu()}


def reduced_card_vs_cpu(torch, kernels, arch, changes=None):
    """`arch`'s reduced config (with `changes`) served on the card and on
    the CPU from the same weights and prompts (batch 4, 128 tokens, 16
    new): prefill logits within rtol 1e-4, atol 1e-4 and the same tokens
    (`same_tokens`); the card may launch flash, once per "A" layer, and
    nothing else."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import modality_stub
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), **(changes or {}))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    prompts = {"tokens": torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                                    (4, 128)))}
    prompts.update({k: torch.as_tensor(v) for k, v in
                    modality_stub(cfg, 4, rs).items()})
    cpu = greedy(torch, cfg, params, prompts, 16)
    for k in kernels.values():
        k.launches = 0
    card = greedy(torch, cfg, tree_map(lambda t: t.cuda(), params),
                  tree_map(lambda t: t.cuda(), prompts), 16)
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    want = {"flash_attention": cfg.num_layers} if "A" in cfg.block_pattern \
        else {}
    if launches != want:
        raise AssertionError(f"reduced {arch} on the card launched "
                             f"{launches}, not {want}")
    lg_err, first_diff, first_near = same_tokens(torch, card, cpu, "CPU")
    return {"config": {k: getattr(cfg, k) for k in (
                "num_layers", "d_model", "num_experts", "experts_per_token")},
            "kernel_launches": launches,
            "prefill_logits_max_abs_diff_vs_cpu": lg_err,
            "first_differing_step": first_diff,
            "first_cpu_near_tie_step": first_near}


def families_path(torch, kernels):
    """Path 4b, the other LM families served at full width on the card
    (`FAMILIES`), launch counts set to 0 just before each `serve`: flash
    launches its count per prefill and no other kernel launches. Where
    flash runs, the same call on the same weights under the naive
    attention launches nothing and agrees (`same_tokens`); where no
    kernel runs (recurrentgemma, xlstm) and for kimi-k2 (too large at
    full width for one card in f32), the reduced config on the card
    against the CPU (`reduced_card_vs_cpu`). Prints per model the layers
    run, the parameter count, prefill s, decode tokens/s, peak memory,
    where flash runs its device ms in one profiled prefill, a profile of
    three decode steps and, for the MoE, each layer's dropped_frac in
    that prefill."""
    import dataclasses

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import modality_stub
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention, moe
    from repro_torch.train import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves
    out = {}
    for arch, layers, prompt_len, flash_want in FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        kw = dict(reduced=False, batch=4, prompt_len=prompt_len, max_new=32,
                  seed=0, device="cuda", num_layers=layers)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = serve(arch, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in kernels.items()}
        emit({"phase": "main_path_launches", "run": f"serve {arch}",
              **launches})
        if launches["flash_attention"] != flash_want or any(
                v for name, v in launches.items()
                if name != "flash_attention"):
            raise AssertionError(f"serving {arch} must launch "
                                 f"flash_attention {flash_want} times and "
                                 f"nothing else: {launches}")
        logits, gen = res["logits"], res["generated"]
        if not (bool(logits.isfinite().all()) and gen.shape == (4, 32)
                and logits.shape == (32, 4, cfg.vocab_size)):
            raise AssertionError(f"{arch}: non-finite logits or wrong shapes")
        row = {"phase": "families", "arch": arch,
               "num_layers": cfg.num_layers,
               "encoder_layers": cfg.encoder_layers,
               "params": sum(t.numel() for t in tree_leaves(res["params"])),
               "batch": 4, "prompt_len": prompt_len, "max_new": 32,
               "prefill_s": res["prefill_s"],
               "decode_tok_per_s": res["decode_tok_per_s"],
               "peak_memory_bytes": peak, "flash_launches": flash_want}
        if flash_want:
            for k in kernels.values():
                k.launches = 0
            attention.set_attn_impl("naive")
            try:
                naive = serve(arch, params=res["params"], **kw)
            finally:
                attention.set_attn_impl("auto")
            if any(k.launches for k in kernels.values()):
                raise AssertionError(f"the naive {arch} run launched a "
                                     "kernel")
            lg_err, first_diff, first_near = same_tokens(torch, res, naive,
                                                         "naive")
            row.update({"naive_prefill_s": naive["prefill_s"],
                        "prefill_logits_max_abs_diff_vs_naive": lg_err,
                        "first_differing_step": first_diff,
                        "first_naive_near_tie_step": first_near})
            del naive

        # flash's device time in one profiled prefill (each MoE layer's
        # dropped_frac recorded there), then three decode steps
        rs = np.random.RandomState(0)
        prompts = {"tokens": torch.as_tensor(rs.randint(
            0, cfg.vocab_size, (4, prompt_len)), device="cuda")}
        prompts.update({k: torch.as_tensor(v, device="cuda") for k, v in
                        modality_stub(cfg, 4, rs).items()})
        step = make_prefill_step(cfg, cache_len=prompt_len + 32)
        dropped, moe_forward = [], moe.moe_forward

        def recording(*a):
            y, aux = moe_forward(*a)
            dropped.append(aux["dropped_frac"])
            return y, aux
        moe.moe_forward = recording
        try:
            if flash_want:
                with torch.no_grad(), profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    _, cache = step(res["params"], prompts)
                    torch.cuda.synchronize()
                dev = [e for e in prof.events()
                       if is_device_work(e, DeviceType)]
                flash = [e.time_range.elapsed_us() / 1e3 for e in dev
                         if "flash_fwd_kernel" in e.name]
                row.update({"flash_device_ms_in_prefill": sum(flash),
                            "flash_launches_in_profile": len(flash),
                            "prefill_device_ms": sum(
                                e.time_range.elapsed_us() for e in dev) / 1e3})
                del prof, dev
            else:                 # no kernel to time; xlstm's prefill is
                with torch.no_grad():          # ~10^5 launches
                    _, cache = step(res["params"], prompts)
        finally:
            moe.moe_forward = moe_forward
        serve_step = make_serve_step(cfg)
        tok = torch.as_tensor(gen[:, 0], device="cuda")
        with torch.no_grad():
            decode = profile_steps(torch, lambda: serve_step(
                res["params"], cache, tok, prompt_len))
        row.update({"decode_step_profile": decode,
                    "sample": gen[0][:8].tolist()})
        if cfg.is_moe:
            row["moe_dropped_frac_in_prefill"] = [float(d) for d in dropped]
        if not flash_want:
            row["reduced_card_vs_cpu"] = reduced_card_vs_cpu(torch, kernels,
                                                             arch)
        emit(row)
        out[arch] = row
        del res, cache
        torch.cuda.empty_cache()
    row = {"phase": "families", "arch": "kimi-k2-1t-a32b",
           "full_width": "not run: one layer's experts are 67.6 GB in f32",
           "reduced_card_vs_cpu": reduced_card_vs_cpu(
               torch, kernels, "kimi-k2-1t-a32b",
               {"num_experts": 16, "experts_per_token": 8})}
    emit(row)
    out["kimi-k2-1t-a32b"] = row
    return out


def profile_round(run_federation, names, tiling: str = "auto",
                  backend: str = "kernel", round_idx: int = 1):
    """Profile an mnist federation under `backend` ("kernel" or "ann")
    and `tiling` and break round
    `round_idx` down: its wall time (the "wpfed.round.<i>" span), the
    host time of each phase span, the device's busy time (summed CUDA
    activity starting inside the span) and idle share, that busy time by
    the phase that launched it (by start time), the device launches, the
    ported kernels' device time and the five costliest device kernels."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_federation("mnist", rounds=round_idx + 1, backend=backend,
                       tiling=tiling, device="cuda", log=None)
    evts = prof.events()
    span = next(e for e in evts if e.name == f"wpfed.round.{round_idx}")
    lo, hi = span.time_range.start, span.time_range.end
    inside = [e for e in evts if lo <= e.time_range.start < hi]
    spans = [e for e in inside if e.device_type == DeviceType.CPU
             and e.name.startswith("wpfed.") and e is not span]
    phases, dev_phase, by_name = Counter(), Counter(), Counter()
    for e in spans:
        phases[e.name[len("wpfed."):]] += e.time_range.elapsed_us() / 1e3
    device = [e for e in inside if is_device_work(e, DeviceType)]
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name[:80]] += ms
        owner = next((p.name[len("wpfed."):] for p in spans
                      if p.time_range.start <= e.time_range.start
                      < p.time_range.end), "other")
        dev_phase[owner] += ms
    wall = span.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    return {"backend": backend, "tiling": tiling, "round": round_idx,
            "wall_ms": wall, "phases_ms": dict(phases),
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "device_ms_by_phase": dict(dev_phase),
            "device_launches": len(device),
            "ported_kernels_ms": sum(v for k, v in by_name.items()
                                     if any(n in k for n in names)),
            "top_device_ms": by_name.most_common(5)}


def ptxas_summary(log: str) -> list:
    """`nvcc -Xptxas -v` output as one line per kernel: its mangled
    symbol, then its registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        elif "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {spill}")
            name = None
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_main_path(run_federation, kernels, **kw):
    """Two mnist rounds on the card, with every kernel's launch count set
    to 0 just before and read just after; emits one line per round and
    returns (history, launches, final state)."""
    for k in kernels.values():
        k.launches = 0
    state, hist = run_federation("mnist", rounds=2, device="cuda", log=None,
                                 **kw)
    launches = {name: k.launches for name, k in kernels.items()}
    for h in hist:
        emit({"phase": "main_path", **kw, "round": h["round"],
              "acc": h["acc"], "mean_loss": h["mean_loss"],
              "seconds": h["seconds"]})
    return hist, launches, state


def expect_launches(launches, used, unused, label):
    """Every kernel of `used` launched at least once, none of `unused`."""
    emit({"phase": "main_path_launches", "run": label, **launches})
    missing = [name for name in used if launches[name] == 0]
    stray = [name for name in unused if launches[name] != 0]
    if missing or stray:
        raise AssertionError(f"{label} run launched no {missing} kernel "
                             f"and {stray} kernels it must not")


def expect_same_run(hist, base, label, id_sets=False,
                    base_label="one-shot kernel"):
    """Round-0 selection and masks equal (with `id_sets`: each row's set
    of ids), accuracy within 0.02 per round, finite losses."""
    if id_sets:
        same = [set(a) for a in hist[0]["neighbor_ids"]] == \
            [set(b) for b in base[0]["neighbor_ids"]]
    else:
        same = hist[0]["neighbor_ids"] == base[0]["neighbor_ids"] and \
            hist[0]["valid_mask"] == base[0]["valid_mask"]
    if not same:
        raise AssertionError(f"round-0 selection of the {label} run differs "
                             f"from the {base_label} run")
    for a, b in zip(hist, base):
        if not (abs(a["acc"] - b["acc"]) <= 0.02
                and all(v == v and abs(v) < 1e30 for v in
                        (a["mean_loss"], b["mean_loss"]))):
            raise AssertionError(f"round {a['round']}: {label} and "
                                 f"{base_label} runs disagree or are not "
                                 "finite")


ATTACK_METRICS = ("attacker_admission_rate", "rank_score_honest",
                  "rank_score_attacker", "valid_neighbor_frac",
                  "honest_reporter_frac")


def attack_run(run_federation, kernels, label, **kw):
    """Three attacked mnist rounds on the card (half the clients attack
    from round 0), every launch count set to 0 just before and read just
    after; one line per round. Returns (history, launches)."""
    for k in kernels.values():
        k.launches = 0
    _, hist = run_federation("mnist", rounds=3, device="cuda", log=None,
                             attack_frac=0.5, attack_start=0, **kw)
    launches = {name: k.launches for name, k in kernels.items()}
    for h in hist:
        emit({"phase": "attack", "run": label, "round": h["round"],
              **{k: h[k] for k in ATTACK_METRICS}, "honest_acc": h["acc"],
              "mean_loss": h["mean_loss"], "seconds": h["seconds"]})
    return hist, launches


def attack_path(run_federation, kernels, paths):
    """§4.7 LSH cheating through `run_federation(attack="lsh_cheat")`:
    the one-shot, tiled and ANN kernel runs must launch their paths'
    kernels and give the plain run's round-0 selection (ANN: id sets) and
    accuracy within 0.02. Round 0 is attacked, so five clients publish
    the target's code: the kernels' tie order on forged codes is held
    against the plain versions'. Then §3.6: under lie_in_reveal the
    one-shot run must flag the liars, honest_reporter_frac 0.5 in every
    round."""
    base, launches = attack_run(run_federation, kernels, "oracle",
                                attack="lsh_cheat", backend="oracle")
    expect_launches(launches, (), set(kernels), "attack oracle")
    for label, used, kw in paths:
        hist, launches = attack_run(run_federation, kernels, label,
                                    attack="lsh_cheat", **kw)
        expect_launches(launches, used, set(kernels) - set(used),
                        f"attack {label}")
        expect_same_run(hist, base, f"attack {label}",
                        id_sets=label == "ann", base_label="attack oracle")
        for h in hist:
            if not 0.0 <= h["attacker_admission_rate"] <= 1.0:
                raise AssertionError(f"attack {label} round {h['round']}: "
                                     "admission rate outside [0, 1]")
    hist, _ = attack_run(run_federation, kernels, "lie_in_reveal one-shot",
                         attack="lie_in_reveal", backend="kernel",
                         tiling="oneshot")
    if any(h["honest_reporter_frac"] != 0.5 for h in hist):
        raise AssertionError("lie_in_reveal: the §3.6 check did not flag "
                             "exactly half of the clients in every round")


def baseline_run(method, ds, device):
    """Two rounds of a baseline built by `make_program` at the mnist
    defaults (`ds`: 10 clients, seed 0) on `device`; the kernel-backed
    LSH of `init_state` on "auto". Returns the history."""
    import dataclasses
    import functools
    import torch
    from repro_torch.core import evaluate, init_state, make_program, run_rounds
    from repro_torch.launch.fed import MODEL_FOR
    from repro_torch.models.client import (apply_client_model,
                                           client_template, init_client_model)
    from repro_torch.optim import adam
    fed = dataclasses.replace(mnist_fed("auto"), exchange_backend="auto")
    mcfg = MODEL_FOR["mnist"]()
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    opt = adam(fed.lr)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in ds.stacked().items()}
    kw = {"shared_ref_x": torch.from_numpy(ds.shared_ref_x).to(device)} \
        if method == "fedmd" else {}
    state = init_state(lambda g: init_client_model(mcfg, g, device), opt,
                       fed, 0)
    _, hist = run_rounds(
        make_program(method, apply_fn, opt, fed, **kw), state, data,
        rounds=2, eval_fn=lambda st, d: {
            "acc": evaluate(apply_fn, st, d)["mean_acc"]})
    return hist


def baselines_path(kernels):
    """The four baselines of Table 2, two rounds each on the card and on
    the CPU from the same seed (the draws come from CPU generators, so
    they are the same): finite losses, accuracy within 0.02 of the CPU
    run's in every round. The card's runs launch the LSH kernel in
    `init_state` and no selection or exchange kernel."""
    from repro_torch.data import DATASETS
    ds = DATASETS["mnist"](seed=0)
    for method in ("silo", "fedmd", "proxyfl", "kdpdfl"):
        for k in kernels.values():
            k.launches = 0
        card = baseline_run(method, ds, "cuda")
        launches = {name: k.launches for name, k in kernels.items()}
        cpu = baseline_run(method, ds, "cpu")
        for a, b in zip(card, cpu):
            emit({"phase": "baselines", "method": method, "round": a["round"],
                  "seconds": a["seconds"], "cpu_seconds": b["seconds"],
                  "mean_loss": a["mean_loss"], "cpu_mean_loss": b["mean_loss"],
                  "acc": a["acc"], "cpu_acc": b["acc"]})
            if not (math.isfinite(a["mean_loss"])
                    and abs(a["acc"] - b["acc"]) <= 0.02):
                raise AssertionError(f"{method} round {a['round']}: loss not "
                                     "finite or accuracy off the CPU run's")
        expect_launches(launches, ("lsh_projection",),
                        set(kernels) - {"lsh_projection"},
                        f"baseline {method}")


def check_auto_tiling_at_scale(torch, gen, m=65_536, bits=256, n=16):
    """One `select_partners` call past the one-shot limit with
    tiling="auto" must launch the tiled kernel, not the one-shot one, and
    give the tiled wrapper's ids."""
    from repro_torch.configs.paper_models import FedConfig
    from repro_torch.core.neighbor import select_partners
    from repro_torch.kernels import selection
    codes, scores = selection_inputs(torch, m, bits, gen, ties=False)
    fed = FedConfig(num_clients=m, num_neighbors=n, lsh_bits=bits)
    t0, o0 = selection.TILED_KERNEL.launches, selection.KERNEL.launches
    ids, mask = select_partners(codes, scores, fed, backend="kernel",
                                tiling="auto")
    launched = (selection.TILED_KERNEL.launches - t0,
                selection.KERNEL.launches - o0)
    want, _ = selection.fused_select_tiled(codes, scores, bits=bits,
                                           gamma=fed.gamma, num_neighbors=n)
    torch.cuda.synchronize()
    emit({"phase": "auto_tiling", "m": m, "bits": bits, "n": n,
          "tiled_launches": launched[0], "oneshot_launches": launched[1]})
    if launched != (1, 0) or not torch.equal(ids, want) or \
            not bool(mask.all()):
        raise AssertionError(f"select_partners(tiling='auto') at M={m} did "
                             f"not take the tiled kernel: {launched}")


def mnist_fed(backend: str = "kernel", **kw):
    """The FedConfig `run_federation("mnist", ...)` builds at its
    defaults (10 clients, N=12 clamped to 9)."""
    from repro_torch.configs.paper_models import (FedConfig,
                                                  PAPER_FED_OPTIMA)
    n_opt, alpha, gamma = PAPER_FED_OPTIMA["mnist"]
    return FedConfig(num_clients=10, num_neighbors=n_opt, alpha=alpha,
                     gamma=gamma, selection_backend=backend,
                     exchange_backend="kernel", **kw)


def check_ann_round0_order(torch, hist):
    """The ANN run's round-0 ids in order: `ann_select_ref` on the round-0
    codes (the initial state's, rebuilt as `run_federation` builds it)
    and the round's scores, candidates from `ann_candidates` seeded with
    round 0."""
    from repro_torch.core import ann, init_state
    from repro_torch.kernels import ref
    from repro_torch.launch.fed import MODEL_FOR
    from repro_torch.models.client import init_client_model
    from repro_torch.optim import adam
    fed = mnist_fed("ann")
    mcfg = MODEL_FOR["mnist"]()
    st = init_state(lambda g: init_client_model(mcfg, g, "cuda"),
                    adam(fed.lr), fed, 0)
    scores = torch.tensor(hist[0]["ranking_scores"], device="cuda")
    n = min(fed.num_neighbors, fed.num_clients - 1)
    cand = ann.ann_candidates(st.codes, scores, seed=0,
                              prefix_bits=fed.ann_prefix_bits,
                              probes=fed.ann_probes, num_neighbors=n)
    lut = ref.selection_lut(st.codes.shape[1], fed.lsh_bits, fed.gamma,
                            device="cuda")
    ids, _ = ref.ann_select_ref(st.codes, scores, cand.ids, lut,
                                num_neighbors=n)
    emit({"phase": "ann_round0_order", "k": cand.ids.shape[1],
          "ids": ids.tolist()})
    if ids.tolist() != hist[0]["neighbor_ids"]:
        raise AssertionError("round-0 ids of the ANN run differ from "
                             "ann_select_ref on the round-0 codes")


def check_auto_ann_at_scale(torch, gen, m=65_536, bits=256, n=16):
    """Path 2: `select_partners(backend="auto")` at M=65,536 on clustered
    codes must launch the grouped ANN kernel once through the route's
    handle and neither the per-row function's handle nor an exact
    kernel, and give `ann_select_ref`'s ids on `ann_candidates` of the
    same codes, which are also the per-row function's (so the recall is
    the per-row route's). Reports K, the occupancy, the route's parts
    (`bucket_candidates` ms, the grouped kernel's device ms) beside the
    per-row function's device ms (one slot a row) on
    `ann_candidates`, the whole ANN selection's ms, and recall@N against
    the tiled exact kernel on the same inputs (device time; the profiler
    may drop records of the 5 ms tiled kernel, so its CUDA-event call time
    is printed too)."""
    from repro_torch.configs.paper_models import FedConfig
    from repro_torch.core import ann
    from repro_torch.core.neighbor import select_partners
    from repro_torch.kernels import ref, selection
    codes, scores = clustered_codes(torch, m, bits, gen)
    fed = FedConfig(num_clients=m, num_neighbors=n, lsh_bits=bits)
    kernels = (selection.GROUPED_KERNEL, selection.ANN_KERNEL,
               selection.KERNEL, selection.TILED_KERNEL)
    before = [k.launches for k in kernels]
    ids, mask = select_partners(codes, scores, fed, backend="auto", seed=0)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    knobs = dict(seed=0, prefix_bits=fed.ann_prefix_bits,
                 probes=fed.ann_probes, num_neighbors=n)
    grouped_cand = lambda: ann.bucket_candidates(  # noqa: E731
        codes, scores, **knobs)
    rows, cand = ann.ann_candidates(codes, scores, **knobs), grouped_cand()
    lut = ref.selection_lut(bits // 32, bits, fed.gamma, device="cuda")
    want, _ = ref.ann_select_ref(codes, scores, rows.ids, lut,
                                 num_neighbors=n)
    per_row = lambda: selection.fused_select_ann(  # noqa: E731
        codes, scores, rows.ids, bits=bits, gamma=fed.gamma, num_neighbors=n)
    grouped = lambda: selection.fused_select_ann_grouped(  # noqa: E731
        codes, scores, cand, bits=bits, gamma=fed.gamma, num_neighbors=n)
    tiled = lambda: selection.fused_select_tiled(  # noqa: E731
        codes, scores, bits=bits, gamma=fed.gamma, num_neighbors=n)
    exact, _ = tiled()
    row_ids, _ = per_row()
    torch.cuda.synchronize()
    hits = (ids.long()[:, :, None] == exact.long()[:, None, :]).any(-1)
    out = {"phase": "auto_ann", "m": m, "bits": bits, "n": n,
           "grouped_launches": launched[0], "per_row_launches": launched[1],
           "oneshot_launches": launched[2], "tiled_launches": launched[3],
           **ann.occupancy_stats(rows), "slots": cand.lists.shape[0],
           "plan": selection.ann_plan(m, bits // 32, n, rows.ids.shape[1],
                                      cand.lists.shape[0]),
           "ids_equal_per_row_kernel": bool(torch.equal(ids, row_ids)),
           "recall_vs_tiled_exact": hits.float().mean().item(),
           "bucket_candidates_ms": time_ms(grouped_cand, iters=5),
           "grouped_kernel_ms": device_ms(grouped,
                                          ("select_ann_grouped_kernel",)),
           "select_partners_ms": time_ms(lambda: select_partners(
               codes, scores, fed, backend="auto", seed=0), iters=5),
           "per_row_kernel_ms": device_ms(per_row,
                                          ("select_ann_rows_kernel",)),
           "tiled_exact_call_ms": time_ms(tiled, iters=5),
           "tiled_exact_ms": device_ms(tiled, ("select_tiled_kernel",),
                                       iters=5)}
    emit(out)
    if launched != [1, 0, 0, 0] or not torch.equal(ids, want) or \
            not torch.equal(ids, row_ids) or not bool(mask.all()):
        raise AssertionError(f"select_partners(backend='auto') at M={m} did "
                             f"not take the grouped ANN kernel or differs "
                             f"from ann_select_ref: {launched}")


def client_codes_and_distances(torch, state, kernels):
    """Path 3 on the one-shot run's final state, with every launch count
    set to 0 just before and read just after: each client's own code
    through the single-client kernel against its row of the published
    codes, and the unfused Eq. 6-8 composition through the Hamming kernel
    against the fused one-shot kernel's ids on the same codes and scores
    (equal, except where two Eq. 8 weights are within 1 ulp: the unfused
    weights run torch.exp on the card, the fused ones gather the table
    built on the CPU)."""
    from repro_torch.core import lsh, neighbor
    from repro_torch.core.protocol import client, select_phase
    from repro_torch.kernels import lsh_projection, ops
    fed = mnist_fed("kernel")
    for k in kernels.values():
        k.launches = 0
    own = torch.stack([lsh.client_lsh_code(client(state.params, i),
                                           state.round, bits=fed.lsh_bits)
                       for i in range(fed.num_clients)])
    sel = select_phase(state, fed)
    dn = lsh.normalized_distance(lsh.distance_matrix(state.codes),
                                 fed.lsh_bits)
    w = neighbor.selection_weights(sel.scores, dn, fed.gamma)
    ids_u, mask_u = neighbor.select_neighbors(w, fed.num_neighbors)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    # near-zero sums: the published (batched) codes' sums of the same rows
    flat = ops.flatten_params_batched(state.params)
    sums = lsh_projection.lsh_project_sums_batched(flat, state.round,
                                                   bits=fed.lsh_bits)
    near = sums.abs() <= 1e-3
    own_bits = ops.unpack_bits(own, fed.lsh_bits).bool()
    pub_bits = ops.unpack_bits(state.codes, fed.lsh_bits).bool()
    wf = torch.gather(w, 1, sel.ids.long())
    wu = torch.gather(w, 1, ids_u.long())
    ulps = (wf.view(torch.int32).long() - wu.view(torch.int32).long()).abs()
    same_ids = torch.equal(sel.ids, ids_u)
    emit({"phase": "client_codes_and_distances", **launches,
          "codes_equal_all_bits": bool(torch.equal(own, state.codes)),
          "near_zero_bits": int(near.sum()),
          "unfused_ids_equal": same_ids,
          "max_weight_ulps_where_ids_differ": int(ulps.max())})
    if not torch.equal(own_bits[~near], pub_bits[~near]):
        raise AssertionError("client_lsh_code differs from the published "
                             "codes off near-zero sums")
    if not (same_ids or int(ulps.max()) <= 1) or not bool(mask_u.all()):
        raise AssertionError("the unfused Eq. 6-8 selection differs from "
                             "the fused kernel's beyond 1-ulp near-ties")
    if launches["lsh_single"] != fed.num_clients or \
            launches["hamming"] != 1:
        raise AssertionError(f"path 3 did not launch lsh_single "
                             f"{fed.num_clients} times and hamming once: "
                             f"{launches}")
    return launches


def zero_grad_mask(torch, path, g):
    """The elements of gradient leaf `g` at `path` whose true gradient is
    0, where both packages return rounding that no leaf maximum scales: a
    key bias `bk` whole (it adds the same q . bk to every score of a
    softmax row), and the sLSTM's input-gate row of its gate biases
    `rec/b` (reps, gate i f z o, D), which scales the unnormalised c and
    n alike (h = o c / n)."""
    mask = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    if path[-1] == "d:bk":
        mask[...] = True
    elif path[-2:] == ("d:rec", "d:b") and g.dim() == 3 and g.shape[1] == 4:
        mask[:, 0] = True
    return mask


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def train_card_vs_cpu(torch, kernels, cfg):
    """`cfg`'s train step on the card against the CPU from the same
    weights (`init_train_state`, CPU generator seeded 0, copied) and
    batch (`TokenStream(cfg, 4, 64, seed=0)`, with its audio or vision):
    the gradients (`loss_and_grads`, remat "block"), then one step of
    AdamW (warm-up cosine, weight decay 0.1, clip 1.0). Bounds: loss,
    ce, moe_aux and grad_norm within 1e-5 relative; each leaf's gradient
    within 1e-4 of the CPU's largest |g| in the leaf, the
    `zero_grad_mask` elements within 1e-6 of the tree's largest; params
    within 1e-6 + 1e-5 |p|, except where the CPU's gradient is nonzero
    and below 1e-3 of its leaf's largest, or in `zero_grad_mask`: Adam's
    g / (|g| + eps) moves by up to 2 lr with g's rounding there (the
    exception of tests/test_torch_train.py); every leaf's gradient
    nonzero on the card (leaves whose true gradient is 0 aside); no
    kernel launched. -> (the line's numbers, the card's params and
    optimizer state after the step, the optimizer)."""
    from repro_torch.data import TokenStream
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.train import (init_train_state, loss_and_grads,
                                   make_train_step)
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    t0 = time.perf_counter()
    sched = linear_warmup_cosine(1e-3, 2, 10)
    lr_1 = sched(torch.tensor(1)).item()          # the first step's lr
    opt = adamw(sched, weight_decay=0.1)
    cpu = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to("cuda", copy=True), cpu)
    batch = {k: torch.as_tensor(v) for k, v in
             TokenStream(cfg, 4, 64, seed=0).next_batch().items()}
    card_batch = {k: v.to("cuda") for k, v in batch.items()}
    for k in kernels.values():
        k.launches = 0
    _, card_g = loss_and_grads(cfg, card[0], card_batch)
    _, cpu_g = loss_and_grads(cfg, cpu[0], batch)
    top = max(c.abs().max().item() for c in tree_leaves(cpu_g))
    zeros = [zero_grad_mask(torch, p, c) for p, c in tree_paths(cpu_g)]
    grad_err, zero_err = 0.0, 0.0
    for g, c, z in zip(tree_leaves(card_g), tree_leaves(cpu_g), zeros):
        diff = (g.cpu() - c).abs()
        if bool(z.any()):
            zero_err = max(zero_err, diff[z].max().item() / top)
        if not bool(z.all()):
            grad_err = max(grad_err, (diff[~z].max()
                                      / c[~z].abs().max()).item())
    zero = ["/".join(p) for (p, g), z in zip(tree_paths(card_g), zeros)
            if not bool(g.any()) and not bool(z.all())]
    if zero:
        raise AssertionError(f"leaves without a gradient on the card: {zero}")
    small = [((c.abs() > 0) & (c.abs() < 1e-3 * c.abs().max())) | z
             for c, z in zip(tree_leaves(cpu_g), zeros)]
    step = make_train_step(cfg, opt)
    cpu_p, _, cpu_m = step(*cpu, batch)
    card_p, card_s, card_m = step(*card, card_batch)
    metric_rel = {k: rel_err(card_m[k].item(), cpu_m[k].item())
                  for k in ("loss", "ce", "moe_aux", "grad_norm")}
    worst, excepted = 0.0, 0
    for a, b, exc in zip(tree_leaves(card_p), tree_leaves(cpu_p), small):
        err = (a.cpu() - b).abs() - 1e-5 * b.abs()
        if not bool(exc.all()):
            worst = max(worst, err[~exc].max().item())
        if bool((err[exc] > 2 * lr_1).any()):
            raise AssertionError("an excepted element moved past 2 lr")
        excepted += int((exc & (err > 1e-6)).sum())
    launched = {n: k.launches for n, k in kernels.items() if k.launches}
    row = {"arch": cfg.name, "num_experts": cfg.num_experts,
           "experts_per_token": cfg.experts_per_token,
           "loss_rel_err": metric_rel["loss"],
           "ce_rel_err": metric_rel["ce"],
           "moe_aux_rel_err": metric_rel["moe_aux"],
           "grad_norm_rel_err": metric_rel["grad_norm"],
           "moe_aux": cpu_m["moe_aux"].item(),
           "grad_max_err_over_leaf_max": grad_err,
           "zero_grad_elements": int(sum(z.sum() for z in zeros)),
           "zero_grad_max_err_over_tree_max": zero_err,
           "param_worst_excess_over_rtol_1e-5": worst,
           "small_grad_elements_past_1e-6": excepted,
           "leaves_with_zero_grad_on_card": len(zero),
           "kernel_launches": launched,
           "seconds": time.perf_counter() - t0}
    if max(metric_rel.values()) > 1e-5 or grad_err > 1e-4 or \
            zero_err > 1e-6 or worst > 1e-6 or launched or \
            (cfg.is_moe and not cpu_m["moe_aux"].item() > 0):
        raise AssertionError(f"the card's train step of {cfg.name} "
                             f"disagrees with the CPU's or launched a "
                             f"kernel: {row}")
    return row, card_p, card_s, opt


def train_path(torch, kernels):
    """Path 5, LM training: (a) the reduced Minitron-4B's step on the card
    against the CPU on the same weights and batch (`train_card_vs_cpu`);
    (b) `train("minitron-4b", reduced=False, ...)` at full width
    (`launcher_run`: no kernel, flash included, may launch), then one
    profiled step; (c) a checkpoint round trip at reduced size."""
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.train import init_train_state
    from repro_torch.tree import tree_leaves

    # (a) the card against the CPU, reduced
    cfg = get_config("minitron-4b").reduced()
    row, card_p, card_s, opt = train_card_vs_cpu(torch, kernels, cfg)
    emit({"phase": "train_card_vs_cpu", **row})

    # (c) checkpoint round trip of the card's reduced state
    ck_dir = str(ROOT / "build" / "chip_smoke_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    ckpt.save(ck_dir, 1, (card_p, card_s))
    like = init_train_state(cfg, opt, torch.Generator(
        device="cuda").manual_seed(1))
    back = ckpt.restore(ck_dir, ckpt.latest_step(ck_dir), like)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves((card_p, card_s))))
    shutil.rmtree(ck_dir)
    emit({"phase": "train_checkpoint", "leaves": len(tree_leaves(back)),
          "equal": same})
    if not same:
        raise AssertionError("checkpoint round trip changed a leaf")
    del card_p, card_s, like, back
    torch.cuda.empty_cache()

    # (b) full width through the launcher
    emit({"phase": "train", **launcher_run(
        torch, kernels, "minitron-4b", 2, 512, "block", 4, "train")})


# the families' training: (a) reduced, card against CPU (kimi-k2 widened
# to 16 experts, top 8, as its published config routes 8 of 384); (b) at
# full width through the launcher: (arch, batch, seq, remat, steps).
# xlstm-350m at 2 x 256 without remat: at 2 x 512 under remat "block" its
# step took 21.5 s (12 sLSTM layers, a Python loop of 512 steps each, 6 x
# 10^5 launches; NVIDIA H100 80GB HBM3, 700 W), over the phase's budget
TRAIN_REDUCED = (("grok-1-314b", {}),
                 ("kimi-k2-1t-a32b", {"num_experts": 16,
                                      "experts_per_token": 8}),
                 ("recurrentgemma-2b", {}), ("xlstm-350m", {}),
                 ("whisper-small", {}), ("llama-3.2-vision-90b", {}))
TRAIN_FULL = (("recurrentgemma-2b", 2, 512, "block", 3),
              ("whisper-small", 2, 448, "block", 3),
              ("xlstm-350m", 2, 256, "none", 2))
# (c) kimi-k2 at published widths (D 7,168, F 2,048, top 8, capacity
# factor 1.25) cut to 1 of its 61 layers and 16 of its 384 experts:
# 3.17e9 parameters, 50.7 GB of f32 params, grads and AdamW moments
TRAIN_KIMI_CUT = {"num_layers": 1, "num_experts": 16}
TRAIN_KIMI_RUN = (2, 512, "block", 3)
PEAK_LIMIT = 80e9


def profiled_train_step(torch, cfg, batch: int, seq: int, remat: str,
                        steps: int):
    """One profiled step (`profile_steps`, after one warm-up step) of
    `make_train_step` on a fresh state of `cfg` (seed 0 on the card) and
    the stream's first batch."""
    from repro_torch.data import TokenStream
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    opt = adamw(linear_warmup_cosine(3e-4, 1, steps), weight_decay=0.1)
    box = list(init_train_state(cfg, opt, torch.Generator(
        device="cuda").manual_seed(0)))
    data = {k: torch.as_tensor(v, device="cuda") for k, v in TokenStream(
        cfg, batch, seq, seed=0).next_batch().items()}
    step = make_train_step(cfg, opt, remat=remat)

    def one_step():
        box[0], box[1], _ = step(box[0], box[1], data)
    prof = profile_steps(torch, one_step, iters=1)
    del box
    torch.cuda.empty_cache()
    return prof


def train_numbers(cfg, n_params, batch, seq, remat, steps, hist, peak,
                  wall):
    """A full-width run's line: per-step seconds and tokens/s from the
    history's elapsed seconds (the loss read back every step), losses and
    grad norms; raises unless the history has every step, every loss and
    grad norm is finite and the peak stays under `PEAK_LIMIT`."""
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    ends = [h["elapsed_s"] for h in hist]
    step_s = [b - a for a, b in zip([0.0] + ends, ends)]
    tokens = batch * seq
    if len(hist) != steps or peak >= PEAK_LIMIT or \
            not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{cfg.name} at full width: {hist}, peak "
                             f"{peak}")
    steady = statistics.mean(step_s[1:]) if len(step_s) > 1 else step_s[0]
    return {"arch": cfg.name, "num_layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "params": n_params,
            "param_count_formula": cfg.param_count(), "batch": batch,
            "seq": seq, "encoder_frames": cfg.encoder_seq_len,
            "remat": remat, "steps": len(hist), "losses": losses,
            "grad_norms": norms, "step_s": step_s,
            "tokens_per_s": [tokens / s for s in step_s],
            "steady_step_s": steady, "steady_tokens_per_s": tokens / steady,
            "call_s": wall, "peak_memory_bytes": peak}


def expect_no_launch(kernels, run: str) -> None:
    launches = {n: k.launches for n, k in kernels.items()}
    emit({"phase": "main_path_launches", "run": run, **launches})
    if any(launches.values()):
        raise AssertionError(f"{run} launched a kernel: {launches}")


def launcher_run(torch, kernels, arch, batch, seq, remat, steps, run):
    """`train(arch, reduced=False, ...)` on the card (seed 0, the loss read
    back every step), launch counts set to 0 just before and read just
    after (`expect_no_launch`, labelled `run`), then one profiled step on
    a fresh state -> the line's numbers (`train_numbers`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    t_run = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, hist = train(arch, reduced=False, batch=batch, seq=seq,
                         remat=remat, steps=steps, seed=0, log_every=1,
                         device="cuda", log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect_no_launch(kernels, run)
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    row = train_numbers(cfg, n_params, batch, seq, remat, steps, hist, peak,
                        wall)
    row["step_profile"] = profiled_train_step(torch, cfg, batch, seq, remat,
                                              steps)
    row["seconds"] = time.perf_counter() - t_run
    return row


def train_families_path(torch, kernels):
    """Path 5b, the other families' training (no kernel lies on it: the
    JAX model trains through its plain attention and no Pallas kernel
    has a backward). (a) `TRAIN_REDUCED` card against CPU
    (`train_card_vs_cpu`); (b) `TRAIN_FULL` through `launch.train.train`
    at published widths and full depth (`launcher_run`); (c) kimi-k2 cut
    to `TRAIN_KIMI_CUT` through `make_train_step` (the launcher has no
    layer cut), counts set to 0 just before and read just after, each
    layer's MoE dropped_frac recorded in each step's forward. grok-1 (one
    layer of 8 experts: 104.5 GB) and llama-3.2-vision (5 layers, its
    first "X": 102.2 GB) train reduced only."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import moe
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    # (a) reduced, the card against the CPU
    for arch, changes in TRAIN_REDUCED:
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        row, *state = train_card_vs_cpu(torch, kernels, cfg)
        emit({"phase": "train_families_card_vs_cpu", **row})
        del state
    torch.cuda.empty_cache()

    # (b) full width through the launcher
    for arch, batch, seq, remat, steps in TRAIN_FULL:
        emit({"phase": "train_families", **launcher_run(
            torch, kernels, arch, batch, seq, remat, steps,
            f"train {arch}")})

    # (c) kimi-k2, one layer of 16 experts at published widths
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                              **TRAIN_KIMI_CUT)
    batch, seq, remat, steps = TRAIN_KIMI_RUN
    stream = TokenStream(cfg, batch, seq, seed=0)
    opt = adamw(linear_warmup_cosine(3e-4, 1, steps), weight_decay=0.1)
    dropped, moe_forward = [], moe.moe_forward

    def recording(*a):
        y, aux = moe_forward(*a)
        dropped.append(aux["dropped_frac"])
        return y, aux
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_run = t0 = time.perf_counter()
    params, opt_state = init_train_state(cfg, opt, torch.Generator(
        device="cuda").manual_seed(0))
    step = make_train_step(cfg, opt, remat=remat)
    hist, aux, drops = [], [], []
    moe.moe_forward = recording
    try:
        t1 = time.perf_counter()
        for i in range(steps):
            data = {k: torch.as_tensor(v, device="cuda")
                    for k, v in stream.next_batch().items()}
            dropped.clear()
            params, opt_state, m = step(params, opt_state, data)
            hist.append({"step": i, "loss": m["loss"].item(),
                         "grad_norm": m["grad_norm"].item(),
                         "elapsed_s": time.perf_counter() - t1})
            aux.append(m["moe_aux"].item())
            # the forward's calls, one a layer; remat recomputes them later
            drops.append([d.item() for d in dropped[:cfg.num_layers]])
    finally:
        moe.moe_forward = moe_forward
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect_no_launch(kernels, "train kimi-k2 cut")
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params, opt_state
    torch.cuda.empty_cache()
    row = train_numbers(cfg, n_params, batch, seq, remat, steps, hist, peak,
                        wall)
    if not all(math.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"kimi-k2's moe_aux {aux}")
    published = get_config("kimi-k2-1t-a32b")
    row.update({"num_experts": cfg.num_experts,
                "published_experts": published.num_experts,
                "published_layers": published.num_layers,
                "experts_per_token": cfg.experts_per_token,
                "d_ff": cfg.d_ff,
                "moe_capacity_factor": cfg.moe_capacity_factor,
                "moe_aux": aux, "moe_dropped_frac_per_step": drops,
                "step_profile": profiled_train_step(torch, cfg, batch, seq,
                                                    remat, steps)})
    row["seconds"] = time.perf_counter() - t_run
    emit({"phase": "train_families", **row})


# the examples phase: each twin of a JAX script or example, its argv (the
# JAX script's sizes; train_lm's 200 steps cut to 20) and the kernels it
# must launch on the card (train_lm: none may)
ONESHOT = ("lsh_projection", "selection", "exchange")
EXAMPLES = (
    ("scripts/torch_service_smoke.py", [], ONESHOT),
    ("scripts/torch_chaos_smoke.py", [], ONESHOT),
    ("scripts/torch_ann_smoke.py", [], ("selection_ann_grouped", "selection")),
    ("scripts/torch_tiled_smoke.py", [],
     ("selection_tiled", "exchange_streamed")),
    ("examples/torch_attack_resilience.py", [], ONESHOT),
    ("examples/torch_quickstart.py", [],
     ONESHOT + ("lsh_single", "hamming", "flash_attention")),
    ("examples/torch_serve_batch.py", [], ("flash_attention",)),
    ("examples/torch_train_lm.py", ["--steps", "20"], ()),
)


def load_twin(path: str):
    """The twin's module, imported from its file in the repository."""
    import importlib.util
    name = Path(path).stem
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_path(torch, kernels):
    """The twins of the JAX package's smoke scripts and examples, each
    `main(argv)` called in this process on the card, every kernel's count
    set to 0 just before and read just after: each kernel of its row in
    `EXAMPLES` must launch, and train_lm none. A twin's own assertions
    fail the run. One line per twin: seconds, launches and the numbers
    its `main` returns."""
    for path, argv, used in EXAMPLES:
        mod = load_twin(path)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        emit({"phase": "examples", "script": path, "argv": argv,
              "seconds": seconds, "launches": launches, **res})
        missing = [name for name in used if launches[name] == 0]
        if missing:
            raise AssertionError(f"{path} launched no {missing} kernel")
        if not used and any(launches.values()):
            raise AssertionError(f"{path} launched a kernel: {launches}")
        torch.cuda.empty_cache()


# the sharding phase: 4 gloo ranks on cuda:0 (two NCCL ranks cannot share
# one card), each made by torch.multiprocessing's spawn
SHARD_WORLD = 4
MINITRON_PARAMS = 4_190_309_376          # configs minitron-4b param_count()
SHARD_SEED, SHARD_BITS = 11, 256
GEN_BLOCK = 1 << 26                      # indices hashed at once
MOE_TOKENS = (4, 2048)
# grok-1 at full width, the FFN width sharded: capacity factor E / k = 4
# gives C = T, which no expert can pass (each token picks an expert once),
# so nothing is dropped; kimi-k2 at full width (D 7,168, F 2,048, top 8)
# with 16 of its 384 experts (E / k = 2: C = T), its experts sharded
SHARD_MOE = {"grok": ("grok-1-314b", {"moe_capacity_factor": 4.0}),
             "kimi16": ("kimi-k2-1t-a32b",
                        {"num_experts": 16, "moe_capacity_factor": 2.0})}


def fill_by_index(torch, out, start: int, real: int, seed: int) -> None:
    """out[i] = a value in [-1, 1) hashed from the global index start + i,
    0 from index `real` on (the padding): any rank makes its own shard of
    one vector, and one process the whole of it."""
    from repro_torch.kernels.ops import K1, K3, MASK32, mul32
    for a in range(0, out.numel(), GEN_BLOCK):
        b = min(a + GEN_BLOCK, out.numel())
        idx = torch.arange(start + a, start + b, dtype=torch.int64,
                           device=out.device)
        h = mul32(idx & MASK32, K1) ^ ((seed * K3) & MASK32)
        h = h ^ (h >> 15)
        h = mul32(h, K3)
        h = h ^ (h >> 13)
        v = (h & 0xFFFFFF).to(torch.float32) * (2.0 / (1 << 24)) - 1.0
        out[a:b] = torch.where(idx < real, v, 0.0)


def shard_moe_cfg(name: str):
    from repro_torch.configs import get_config
    arch, changes = SHARD_MOE[name]
    return dataclasses.replace(get_config(arch), **changes)


def shard_moe_params(torch, name: str, cfg, rank=None, world=SHARD_WORLD):
    """The MoE layer's weights, each expert's FFN made as `world` column
    blocks (wi, wg) / row blocks (wo), each from its own generator; with
    `rank`, only that rank's slice by `moe_specs` (its experts, or every
    expert's rank-th block)."""
    from repro_torch.models import moe
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    e_sharded = e >= moe.EXPERT_SHARD_MIN
    fb = f // world

    def block(key, ex, b, shape, scale):
        g = torch.Generator(device="cuda")
        g.manual_seed(1_000_003 * (key + 1) + 1_009 * ex + b)
        return torch.randn(shape, generator=g, device="cuda") * scale

    experts = range(e) if rank is None or not e_sharded else \
        range(rank * e // world, (rank + 1) * e // world)
    blocks = range(world) if rank is None or e_sharded else (rank,)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    p = {"router": torch.randn((d, e), generator=g, device="cuda")
         * d ** -0.5}
    for key, name_ in enumerate(("wi", "wg", "wo")):
        if name_ not in moe.moe_shapes(cfg):
            continue
        up = name_ != "wo"
        w = torch.empty((len(experts), d, fb * len(blocks)) if up else
                        (len(experts), fb * len(blocks), d), device="cuda")
        for i, ex in enumerate(experts):
            for j, b in enumerate(blocks):
                cols = slice(j * fb, (j + 1) * fb)
                if up:
                    w[i, :, cols] = block(key, ex, b, (d, fb), d ** -0.5)
                else:
                    w[i, cols] = block(key, ex, b, (fb, d), f ** -0.5)
        p[name_] = w
    return p


def shard_moe_tokens(torch, cfg):
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    return torch.randn((*MOE_TOKENS, cfg.d_model), generator=g,
                       device="cuda")


def sharding_rank(rank: int, world: int, plan: dict) -> dict:
    """One of the sharding phase's ranks (gloo, on cuda:0): its shard of
    the LSH vector through `sharded_lsh_code` (count set to 0 just
    before, read just after); both MoE layers on its slice of the
    weights placed on a (1, world) mesh (`moe_forward`'s expert-parallel
    path); the local shards of Minitron-4B's params
    (2 layers) placed on a (2, 2) ("data", "model") mesh."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import lsh
    from repro_torch.device import resolve_device
    from repro_torch.kernels import lsh_projection, ref
    from repro_torch.kernels.ops import CHUNK
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.sharding import local_shape, place, placements, \
        to_local, tp
    from repro_torch.tree import tree_paths
    from torch.distributed.tensor import DTensor
    resolve_device("cuda")
    torch.cuda.set_device(0)
    out = {}

    # 1. the sharded LSH code; then each rank's kernel and the all-reduce
    # timed alone, one rank after another
    n = plan["lsh_p"] // world
    shard = torch.empty(n, device="cuda")
    fill_by_index(torch, shard, rank * n, MINITRON_PARAMS, SHARD_SEED)
    kernel = lsh_projection.SINGLE_KERNEL
    torch.cuda.synchronize()
    dist.barrier()
    kernel.launches = 0
    code = lsh.sharded_lsh_code(shard, SHARD_SEED, SHARD_BITS)
    torch.cuda.synchronize()
    launches = kernel.launches
    padded = F.pad(shard, (0, (-n) % CHUNK))
    del shard
    kw = dict(bits=SHARD_BITS, row_offset=rank * n)
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            sums = lsh_projection.lsh_project_sums(padded, SHARD_SEED, **kw)
            kernel_ms = time_ms(lambda: lsh_projection.lsh_project_sums(
                padded, SHARD_SEED, **kw), warmup=0, iters=3)
    # the last rank's shard (rows 3.14e9 on) against the plain version,
    # the others waiting: sums within 1e-5 of |sum| + ||x||, and equal
    # bits wherever |sum| > 1e-3
    plain = None
    if rank == world - 1:
        t0 = time.perf_counter()
        want = ref.lsh_project_sums_ref(padded, SHARD_SEED, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = (sums - want).abs()
        firm = want.abs() > 1e-3
        plain = {"row_offset": rank * n, "plain_s": plain_s,
                 "max_abs_err": err.max().item(),
                 "sums_ok": bool((err <= 1e-5 * (want.abs()
                                                 + padded.norm())).all()),
                 "firm_bits": int(firm.sum()),
                 "bits_equal": bool(torch.equal((sums > 0)[firm],
                                                (want > 0)[firm]))}
    partial = torch.ones(SHARD_BITS, device="cuda")
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(partial)
    torch.cuda.synchronize()
    out["lsh"] = {"code": code.cpu(), "launches": launches,
                  "row_offset": rank * n, "shard_p": padded.numel(),
                  "kernel_ms": kernel_ms, "plain": plain,
                  "allreduce_ms": (time.perf_counter() - t0) * 1e3}
    del padded
    torch.cuda.empty_cache()

    # 2. expert parallelism: each rank makes its slice of the weights,
    # placed by `moe_specs` on a (1, world) mesh with the tokens
    mesh = make_device_mesh((1, world), ("data", "model"), "cuda")
    for name in SHARD_MOE:
        cfg = shard_moe_cfg(name)
        specs, shapes = moe.moe_specs(cfg), moe.moe_shapes(cfg)
        p = {k: DTensor.from_local(
            v, mesh, placements(specs[k], mesh), run_check=False,
            shape=shapes[k], stride=torch.empty(shapes[k], device="meta")
            .stride()) for k, v in shard_moe_params(
                torch, name, cfg, rank, world).items()}
        x = tp.place_batch(shard_moe_tokens(torch, cfg), mesh)
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        got, aux = moe.moe_forward(cfg, p, x)
        torch.cuda.synchronize()
        times = []
        for _ in range(2):
            dist.barrier()
            t0 = time.perf_counter()
            moe.moe_forward(cfg, p, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"out": got.to_local().cpu(), "load_balance": float(
            aux["load_balance"]), "dropped_frac": float(aux["dropped_frac"]),
            "ms": min(times), "peak_gb":
            torch.cuda.max_memory_allocated() / 1e9,
            "wi": tuple(p["wi"].to_local().shape)}
        del p, x, got
        torch.cuda.empty_cache()

    # 3. the (2, 2) mesh: every local shard is its spec's block
    mesh = make_device_mesh((2, 2), ("data", "model"), "cuda")
    cfg = dataclasses.replace(get_config("minitron-4b"), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen)                 # the same on every rank
    specs = param_specs(cfg)
    local = to_local(place(params, mesh, specs))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    bad, leaves = [], 0
    for (path, t), (_, spec), (_, g) in zip(tree_paths(local),
                                            tree_paths(specs),
                                            tree_paths(params)):
        want = local_shape(g.shape, spec, mesh)
        for d, ax in enumerate(spec):
            if ax is not None:
                g = g.narrow(d, coord[ax] * want[d], want[d])
        leaves += 1
        if tuple(t.shape) != want or not torch.equal(t, g):
            bad.append(("/".join(path), tuple(t.shape), want))
    out["mesh22"] = {"leaves": leaves, "bad": bad, "coord": coord}
    return out


def spec_elems(shape, spec, sizes) -> int:
    """Elements one device holds of a `shape` leaf laid out by `spec` on
    axes of `sizes`, a dimension its axes do not divide replicated (the
    dryrun's rule, written out here independently)."""
    n = 1
    for d, dim in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        div = math.prod(sizes[a] for a in axes)
        n *= dim // div if dim % div == 0 else dim
    return n


def sharding_path(torch, kernels):
    """Path 6, sharding: the unsharded references on this process first,
    then 4 spawned gloo ranks on cuda:0 (`sharding_rank`), then
    Minitron-4B's params placed on a (1, 1) NCCL mesh of this process,
    then the dryrun of kimi-k2 on meta. Returns the launches of the
    sharded runs: B.2 summed over the ranks (1 each), flash in the placed
    prefill (4)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import lsh_projection, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, spawn_ranks
    from repro_torch.models import moe
    from repro_torch.models.transformer import (init_params, meta_params,
                                                param_specs)
    from repro_torch.sharding import place, to_local
    from repro_torch.train import make_prefill_step
    from repro_torch.tree import tree_leaves

    # 1. the whole vector's code by the unsharded kernel (a comparison
    # launch: counted nowhere)
    p_pad = -(-MINITRON_PARAMS // ops.CHUNK) * ops.CHUNK
    x = torch.empty(p_pad, device="cuda")
    fill_by_index(torch, x, 0, MINITRON_PARAMS, SHARD_SEED)
    n0 = lsh_projection.SINGLE_KERNEL.launches
    whole = lsh_projection.lsh_project_sums(x, SHARD_SEED, bits=SHARD_BITS)
    whole_ms = time_ms(lambda: lsh_projection.lsh_project_sums(
        x, SHARD_SEED, bits=SHARD_BITS), warmup=0, iters=2)
    lsh_projection.SINGLE_KERNEL.launches = n0
    plan = {"lsh_p": p_pad}
    del x
    torch.cuda.empty_cache()
    # the unsharded MoE layers, one process, the same weights
    refs = {}
    for name in SHARD_MOE:
        cfg = shard_moe_cfg(name)
        p = shard_moe_params(torch, name, cfg)
        xt = shard_moe_tokens(torch, cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        o, aux = moe.apply_moe(cfg, p, xt)
        torch.cuda.synchronize()
        refs[name] = {"out": o.cpu(), "ms": (time.perf_counter() - t0) * 1e3,
                      "load_balance": float(aux["load_balance"]),
                      "dropped_frac": float(aux["dropped_frac"]),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del p, xt, o
        torch.cuda.empty_cache()

    # 2. the ranks
    t0 = time.perf_counter()
    ranks = spawn_ranks(sharding_rank, SHARD_WORLD, plan)
    ranks_s = time.perf_counter() - t0
    firm = whole.abs() > 1e-3
    want_bits = (whole > 0)[firm].cpu()
    for r, res in enumerate(ranks):
        got = ops.unpack_bits(res["lsh"]["code"], SHARD_BITS)[firm.cpu()]
        if not torch.equal(got.bool(), want_bits) or \
                res["lsh"]["launches"] != 1:
            raise AssertionError(
                f"rank {r}: the sharded code disagrees with the unsharded "
                f"kernel's on a bit with |sum| > 1e-3, or B.2 launched "
                f"{res['lsh']['launches']} times, not 1")
    plain = ranks[-1]["lsh"]["plain"]
    if not (plain["sums_ok"] and plain["bits_equal"]):
        raise AssertionError(f"rank {SHARD_WORLD - 1}'s B.2 launch at row "
                             f"offset {plain['row_offset']} disagrees with "
                             f"its plain version: {plain}")
    bms, by = bound(4.0 * p_pad + 4.0 * SHARD_BITS, max(
        2.0 * p_pad * SHARD_BITS / F32_FLOP_PER_S,
        HASH_OPS * p_pad * SHARD_BITS / INT32_OP_PER_S))
    emit({"phase": "sharding_lsh", "p": MINITRON_PARAMS, "p_padded": p_pad,
          "bits": SHARD_BITS, "ranks": SHARD_WORLD,
          "firm_bits": int(firm.sum()), "codes_equal_on_firm_bits": True,
          "unsharded_kernel_ms": whole_ms, "unsharded_bound_ms": bms,
          "bound_by": by,
          "row_offsets": [r["lsh"]["row_offset"] for r in ranks],
          "shard_p": ranks[0]["lsh"]["shard_p"],
          "rank_kernel_ms": [r["lsh"]["kernel_ms"] for r in ranks],
          "allreduce_ms_gloo_through_the_host":
          [r["lsh"]["allreduce_ms"] for r in ranks],
          "launches_per_rank": [r["lsh"]["launches"] for r in ranks],
          "last_rank_against_plain": plain, "ranks_wall_s": ranks_s})
    for name in SHARD_MOE:
        ref = refs[name]
        for r, res in enumerate(ranks):
            got = res[name]
            err = (got["out"] - ref["out"]).abs().max().item()
            if err > 1e-4 or abs(got["load_balance"]
                                 - ref["load_balance"]) > 1e-4 \
                    or got["dropped_frac"] != ref["dropped_frac"]:
                raise AssertionError(
                    f"{name} rank {r}: sharded MoE off the unsharded layer "
                    f"(max err {err}, load_balance {got['load_balance']} vs "
                    f"{ref['load_balance']}, dropped {got['dropped_frac']} "
                    f"vs {ref['dropped_frac']})")
        if name == "grok" and ref["dropped_frac"] != 0.0:
            raise AssertionError("grok-1's layer dropped tokens at C = T")
        cfg = shard_moe_cfg(name)
        emit({"phase": "sharding_moe", "layer": name, "arch": cfg.name,
              "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
              "d_model": cfg.d_model, "d_ff": cfg.d_ff,
              "tokens": math.prod(MOE_TOKENS),
              "sharded": "experts" if cfg.num_experts
              >= moe.EXPERT_SHARD_MIN else "ffn width",
              "rank_wi_shape": ranks[0][name]["wi"],
              "max_abs_err": max((r[name]["out"] - ref["out"]).abs().max()
                                 .item() for r in ranks),
              "load_balance": ref["load_balance"],
              "dropped_frac": ref["dropped_frac"],
              "unsharded_ms": ref["ms"], "unsharded_peak_gb": ref["peak_gb"],
              "rank_ms": [r[name]["ms"] for r in ranks],
              "rank_peak_gb": [r[name]["peak_gb"] for r in ranks]})
    for r, res in enumerate(ranks):
        if res["mesh22"]["bad"] or res["mesh22"]["leaves"] < 10:
            raise AssertionError(f"rank {r} of the (2, 2) mesh: local shards "
                                 f"off their specs: {res['mesh22']}")
    emit({"phase": "sharding_mesh22", "leaves": ranks[0]["mesh22"]["leaves"],
          "coords": [r["mesh22"]["coord"] for r in ranks],
          "local_shards_equal_spec_blocks": True})

    # 3. Minitron-4B (4 of 32 layers) placed by param_specs on a (1, 1)
    # NCCL mesh: a 2,048-token prefill, flash once per layer
    cfg = dataclasses.replace(get_config("minitron-4b"), num_layers=4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    tokens = {"tokens": torch.randint(0, cfg.vocab_size, (1, 2048),
                                      generator=gen, device="cuda")}
    step = make_prefill_step(cfg)
    with torch.no_grad():
        plain, _ = step(params, tokens)
        mesh = make_host_mesh("cuda")
        try:
            placed = place(params, mesh, param_specs(cfg))
            local = to_local(placed)
            for k in kernels.values():
                k.launches = 0
            got, _ = step(local, tokens)
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in kernels.items()}
            # the tensor-parallel forward on the placed params themselves
            for k in kernels.values():
                k.launches = 0
            got_tp, _ = step(placed, tokens)
            torch.cuda.synchronize()
            launches_tp = {name: k.launches for name, k in kernels.items()}
            got_tp = got_tp.to_local()
        finally:
            dist.destroy_process_group()
    emit({"phase": "main_path_launches", "run": "sharding placed prefill",
          **launches})
    emit({"phase": "main_path_launches",
          "run": "tensor-parallel prefill, 1x1 nccl", **launches_tp})
    for run, ls, lg in (("placed", launches, got),
                        ("tensor-parallel", launches_tp, got_tp)):
        if ls["flash_attention"] != 4 or any(
                v for n, v in ls.items() if n != "flash_attention") \
                or not torch.equal(lg, plain):
            raise AssertionError(f"the {run} prefill must launch flash 4 "
                                 f"times and nothing else ({ls}) and give "
                                 f"the unplaced logits bit for bit")
    emit({"phase": "sharding_placed", "arch": cfg.name, "num_layers": 4,
          "mesh": "1x1 nccl", "leaves": len(tree_leaves(placed)),
          "logits_bitwise_equal": True,
          "tensor_parallel_logits_bitwise_equal": True})
    del params, placed, local, plain, got, got_tp
    torch.cuda.empty_cache()

    # 4. the dryrun on meta; params + optimizer against the spec
    # arithmetic written out here
    res = dryrun.dryrun_one("kimi-k2-1t-a32b", "train_4k", verbose=False)
    kimi = get_config("kimi-k2-1t-a32b")
    sizes = {"data": 16, "model": 16}
    elems = sum(spec_elems(t.shape, sp, sizes) for t, sp in zip(
        tree_leaves(meta_params(kimi)), tree_leaves(param_specs(kimi))))
    want = elems * 2 + elems * 4 * 2 + 4      # bf16 params; f32 m, v; step
    got = res["bytes_per_device"]["params"] + \
        res["bytes_per_device"]["optimizer"]
    if got != want:
        raise AssertionError(f"dryrun params + optimizer {got} bytes per "
                             f"device, the specs give {want}")
    emit({"phase": "sharding_dryrun", **{k: res[k] for k in (
        "arch", "shape", "mesh", "chips", "device", "bytes_per_device",
        "flops_per_device", "flops", "roofline", "wall_s")},
        "params_plus_optimizer_equal_spec_arithmetic": True})
    return {"lsh_single": sum(r["lsh"]["launches"] for r in ranks),
            "flash_attention": launches["flash_attention"]}


# the tensor-parallel forward on a (1, 4) ("data", "model") mesh of 4
# gloo ranks: (arch, layers kept) at full width, f32, one 2,048-token
# prompt; Minitron-4B also decodes 4 teacher-forced tokens
TP_CASES = (("minitron-4b", 4), ("phi3-medium-14b", 2),
            ("recurrentgemma-2b", 3))
TP_PROMPT, TP_DECODE, TP_SEED = 2048, 4, 11
# logits: max abs error over max |logit| of the unsharded forward (f32;
# the row-parallel sums over 4 ranks add in another order)
TP_REL_TOL = 1e-4


def tp_draw(torch, cfg):
    """Minitron-style params, the prompt and the decode tokens, drawn on
    the card from TP_SEED (the same numbers in every process)."""
    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_SEED)
    params = init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (1, TP_PROMPT), generator=gen,
                           device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (TP_DECODE, 1), generator=gen,
                          device="cuda")
    return params, prompt, steps


def tp_bytes(cfg, rows: int, n: int) -> dict:
    """Collective bytes (f32) and counts one rank issues in a
    tensor-parallel forward of `rows` token positions on a "model" axis
    of n, written out here from the head rule: one all-reduce of the
    embedding, one of each block's output and of each MLP's; where n does
    not divide the query heads, one all-gather of q (H * dh columns) and
    of k and v (KV * dh each); where it divides the query heads but not
    the K/V heads, of k and v; an R block gathers its u (W columns)."""
    act = rows * cfg.d_model * 4
    out = {"all-reduce": act, "all-gather": 0, "reduces": 1, "gathers": 0}
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for i in range(cfg.num_layers):
        t = cfg.block_pattern[i % len(cfg.block_pattern)]
        blocks = 2 if cfg.d_ff else 1
        out["all-reduce"] += blocks * act
        out["reduces"] += blocks
        if t in "ALX":
            if h % n:
                out["all-gather"] += rows * h * dh * 4
                out["gathers"] += 1
            if h % n or kv % n:
                out["all-gather"] += 2 * rows * kv * dh * 4
                out["gathers"] += 2
        elif t == "R":
            out["all-gather"] += rows * (cfg.lru_width or cfg.d_model) * 4
            out["gathers"] += 1
    return out


def kernel_objects():
    """Every CUDA kernel of the port by name (each process has its own
    launch counts)."""
    from repro_torch.kernels import (exchange, flash_attention, hamming,
                                     lsh_projection, selection)
    return {"lsh_projection": lsh_projection.KERNEL,
            "selection": selection.KERNEL, "exchange": exchange.KERNEL,
            "selection_tiled": selection.TILED_KERNEL,
            "exchange_streamed": exchange.STREAMED_KERNEL,
            "selection_ann": selection.ANN_KERNEL,
            "selection_ann_grouped": selection.GROUPED_KERNEL,
            "lsh_single": lsh_projection.SINGLE_KERNEL,
            "hamming": hamming.KERNEL,
            "flash_attention": flash_attention.KERNEL}


def counted(records) -> dict:
    out = {}
    for r in records:
        out[r["kind"]] = out.get(r["kind"], 0) + r["bytes"]
        out[r["kind"] + " count"] = out.get(r["kind"] + " count", 0) + 1
    return out


def tp_core_check(torch, cfg, placed, rank: int):
    """One rank's attention core at its own shapes (the head rule of the
    first attention layer: its query heads, and its K/V heads taken by
    `HeadPlan.take_kv`), on unit-normal q, k, v of TP_PROMPT tokens: the
    route the prefill takes (flash) against the naive route, within
    check_flash's f32 tolerance, 2e-5. None without an "A" layer."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import attention
    from repro_torch.sharding import tp
    if "A" not in cfg.block_pattern:
        return None
    # the stacked params of the pattern's first "A" block
    p = placed["layers"][cfg.block_pattern.index("A")]["attn"]
    plan = tp.head_plan(cfg, p["wq"], p["wk"])
    dh = cfg.resolved_head_dim
    kv = plan.kv_heads if plan.kv_split else cfg.num_kv_heads
    dev = p["wq"].to_local().device
    gen = torch.Generator(device=dev)
    gen.manual_seed(TP_SEED + rank)
    q = torch.randn((1, TP_PROMPT, plan.heads, dh), generator=gen,
                    device=dev)
    k, v = (torch.randn((1, TP_PROMPT, kv, dh), generator=gen, device=dev)
            for _ in range(2))
    lcfg = plan.cfg(cfg)

    def core():
        return attention._attend(lcfg, q, plan.take_kv(k), plan.take_kv(v),
                                 "causal", 0, False)
    n0 = flash_attention.KERNEL.launches
    got = core()
    launches = flash_attention.KERNEL.launches - n0
    attention.set_attn_impl("naive")
    try:
        want = core()
    finally:
        attention.set_attn_impl("auto")
    return {"q_heads": plan.heads, "kv_heads": plan.kv_heads,
            "kv_index": plan.kv_index, "flash_launches": launches,
            "max_abs_err": (got - want).abs().max().item()}


def sharding_tp_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of the tensor-parallel phase (gloo, on cuda:0, a (1, 4)
    mesh): for each case, each rank draws the whole params from the same
    seed and keeps its shards only (`place_params`, each shard copied
    out, the rest freed: 4 x 8 GB at most at once); then the prefill with every count set to 0 just before
    and read just after, its collectives recorded, and for Minitron-4B
    the decode steps; the prefill again, timed; one all-reduce of the
    row-parallel payload, timed. Returns the rank's vocabulary shard of
    each logits tensor."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.dryrun import CollectiveCounter, _mesh_axes
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.sharding import place_params
    from repro_torch.tree import tree_map
    resolve_device("cuda")
    torch.cuda.set_device(0)
    mesh = make_device_mesh((1, world), ("data", "model"), "cuda")
    kernels = kernel_objects()
    out = {}
    for arch, layers in TP_CASES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        full, prompt, steps = tp_draw(torch, cfg)
        placed = tree_map(lambda d: DTensor.from_local(
            d.to_local().clone(), d.device_mesh, d.placements,
            run_check=False, shape=d.shape, stride=d.stride()),
            place_params(cfg, full, mesh))
        del full
        torch.cuda.empty_cache()
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        with torch.no_grad(), CollectiveCounter(_mesh_axes(mesh)) as pre:
            logits, cache = prefill(cfg, placed, prompt,
                                    cache_len=TP_PROMPT + TP_DECODE)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        res = {"logits": logits.to_local().cpu(), "launches": launches,
               "prefill": counted(pre.records)}
        if arch == "minitron-4b":
            dec = []
            with torch.no_grad(), CollectiveCounter(_mesh_axes(mesh)) as rec:
                for i in range(TP_DECODE):
                    lg, cache = decode_step(cfg, placed, cache, steps[i],
                                            TP_PROMPT + i)
                    dec.append(lg.to_local().cpu())
            res["decode"], res["decode_bytes"] = dec, counted(rec.records)
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del cache
        torch.cuda.empty_cache()
        res["core"] = tp_core_check(torch, cfg, placed, rank)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            prefill(cfg, placed, prompt, cache_len=TP_PROMPT + TP_DECODE)
        torch.cuda.synchronize()
        res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        payload = torch.ones((1, TP_PROMPT, cfg.d_model), device="cuda")
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(payload, group=mesh.get_group("model"))
        torch.cuda.synchronize()
        res["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
        out[arch] = res
        del placed, logits, payload
        torch.cuda.empty_cache()
    return out


def sharding_tp_path(torch, kernels):
    """Path 6c, the tensor-parallel forward: each case's unsharded
    prefill (and Minitron-4B's decode) on this process first, then 4
    spawned gloo ranks on cuda:0 (`sharding_tp_rank`), the ranks'
    vocabulary shards put side by side and held against it, their
    collective bytes against `tp_bytes`, their launches: flash once per
    layer of a prefill whose heads "model" divides or gathers, nothing
    else. Returns the flash launches of Minitron-4B's tensor-parallel
    prefill, summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.transformer import decode_step, prefill

    refs = {}
    for arch, layers in TP_CASES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        params, prompt, steps = tp_draw(torch, cfg)
        with torch.no_grad():
            for _ in range(2):            # the second call timed (warm)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = prefill(cfg, params, prompt,
                                        cache_len=TP_PROMPT + TP_DECODE)
                torch.cuda.synchronize()
            ref = {"logits": logits.cpu(),
                   "ms": (time.perf_counter() - t0) * 1e3}
            if arch == "minitron-4b":
                ref["decode"] = [decode_step(cfg, params, cache, steps[i],
                                             TP_PROMPT + i)[0].cpu()
                                 for i in range(TP_DECODE)]
        refs[arch] = ref
        del params, cache, logits
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_ranks(sharding_tp_rank, SHARD_WORLD, {})
    ranks_s = time.perf_counter() - t0
    flash = {}
    for arch, layers in TP_CASES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        ref = refs[arch]
        got = torch.cat([r[arch]["logits"] for r in ranks], dim=-1)
        scale = ref["logits"].abs().max().item()
        err = (got - ref["logits"]).abs().max().item()
        dec_err = 0.0
        if arch == "minitron-4b":
            for i in range(TP_DECODE):
                g = torch.cat([r[arch]["decode"][i] for r in ranks], dim=-1)
                dec_err = max(dec_err, (g - ref["decode"][i]).abs().max()
                              .item() / ref["decode"][i].abs().max().item())
        want = tp_bytes(cfg, TP_PROMPT, SHARD_WORLD)
        want_dec = tp_bytes(cfg, 1, SHARD_WORLD)
        per_layer_flash = sum(cfg.block_pattern[i % len(cfg.block_pattern)]
                              == "A" for i in range(layers))
        bad = []
        for r, res in enumerate(ranks):
            mine = res[arch]
            got_b = mine["prefill"]
            if (got_b.get("all-reduce", 0), got_b.get("all-gather", 0),
                    got_b.get("all-reduce count", 0),
                    got_b.get("all-gather count", 0)) != (
                    want["all-reduce"], want["all-gather"], want["reduces"],
                    want["gathers"]) or set(got_b) - {
                    "all-reduce", "all-gather", "all-reduce count",
                    "all-gather count"}:
                bad.append((r, "prefill bytes", got_b, want))
            if arch == "minitron-4b":
                db = mine["decode_bytes"]
                if (db.get("all-reduce", 0), db.get("all-gather", 0)) != (
                        TP_DECODE * want_dec["all-reduce"],
                        TP_DECODE * want_dec["all-gather"]):
                    bad.append((r, "decode bytes", db, want_dec))
            if mine["launches"]["flash_attention"] != per_layer_flash or any(
                    v for n, v in mine["launches"].items()
                    if n != "flash_attention"):
                bad.append((r, "launches", mine["launches"]))
            core = mine["core"]
            if per_layer_flash and (core is None
                                    or core["flash_launches"] != 1
                                    or not core["max_abs_err"] < 2e-5):
                bad.append((r, "attention core against naive", core))
        if err > TP_REL_TOL * scale or dec_err > TP_REL_TOL or bad:
            raise AssertionError(
                f"{arch} tensor-parallel prefill on 4 ranks: max abs error "
                f"{err} (max |logit| {scale}), decode relative {dec_err}, "
                f"against the unsharded forward (limit {TP_REL_TOL}); "
                f"mismatches {bad}")
        flash[arch] = sum(r[arch]["launches"]["flash_attention"]
                          for r in ranks)
        emit({"phase": "sharding_tp", "arch": arch, "num_layers": layers,
              "mesh": "1x4 gloo (one card)", "prompt": TP_PROMPT,
              "heads": [cfg.num_heads, cfg.num_kv_heads],
              "head_rule": ("heads split" if cfg.num_heads % SHARD_WORLD == 0
                            and cfg.num_kv_heads % SHARD_WORLD == 0 else
                            "q split, K/V gathered" if cfg.num_heads
                            % SHARD_WORLD == 0 else "every head on every "
                            "rank"),
              "logits_max_abs_err": err, "max_abs_logit": scale,
              "tolerance_rel": TP_REL_TOL,
              "decode_rel_err": dec_err if arch == "minitron-4b" else None,
              "prefill_bytes_per_rank": ranks[0][arch]["prefill"],
              "prefill_bytes_formula": want,
              "decode_bytes_per_rank": ranks[0][arch].get("decode_bytes"),
              "flash_launches_per_rank": [r[arch]["launches"][
                  "flash_attention"] for r in ranks],
              "rank_core_vs_naive": [r[arch]["core"] for r in ranks],
              "unsharded_prefill_ms": ref["ms"],
              "rank_prefill_ms": [r[arch]["prefill_ms"] for r in ranks],
              "allreduce_ms_gloo_through_the_host": [
                  r[arch]["allreduce_ms"] for r in ranks],
              "rank_peak_gb": [r[arch]["peak_gb"] for r in ranks],
              "ranks_wall_s": ranks_s})
    emit({"phase": "main_path_launches", "run": "tensor-parallel prefill",
          "arch": "minitron-4b", "flash_attention": flash["minitron-4b"],
          "per_rank": flash["minitron-4b"] // SHARD_WORLD})
    return flash


SERVICE = dict(reselect_every=4, churn="1:leave:3,1:leave:8,2:join:3",
               gossip_counts="4,4,2,4,1,4,3,4,4,2")
SERVICE_FAULTS = ("seed=7,drop=0.1,delay=0.1,duplicate=0.1,corrupt=0.1,"
                  "straggle=0.2,publish_fail=0.3,fetch_fail=0.3,fork=1")
FAULT_KEYS = ("fault_stragglers", "fault_dropped", "fault_delayed",
              "fault_corrupt", "fault_duplicates", "fault_publish_retries",
              "fault_fetch_retries", "degraded_round")


def same_tree(torch, a, b) -> bool:
    """Two state trees equal leaf for leaf, bit for bit."""
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def no_seconds(hist):
    return [{k: v for k, v in h.items() if k != "seconds"} for h in hist]


def service_routes(torch, kernels, state):
    """`select_phase(active=, score_scale=)` on the service's final state
    through the tiled kernel and the grouped ANN kernel (launch counts set
    to 0 just before each and read just after), held against the same
    call through the plain versions on the CPU (the tiled one by
    backend "oracle", ANN by its own route): ids on every rank and
    masks equal (ANN: ids 0 where the weight is not finite, as
    `ann_select_ref`)."""
    from repro_torch.core.protocol import select_phase
    from repro_torch.service import staleness_discount
    from repro_torch.tree import tree_map
    cpu = tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                   state)
    # client 8 is still departed; client 5 leaves as well, so more rows
    # carry masked ranks
    active = state.active.clone()
    active[5] = False
    out = {}
    for label, kw, name in (("tiled", dict(selection_tiling="tiled"),
                             "selection_tiled"),
                            ("ann", dict(ann_prefix_bits=10, ann_probes=8),
                             "selection_ann_grouped")):
        fed = mnist_fed("ann" if label == "ann" else "kernel", **kw)
        for k in kernels.values():
            k.launches = 0
        got = select_phase(state.fed, fed, active=active,
                           score_scale=staleness_discount(state.code_age,
                                                          0.5))
        torch.cuda.synchronize()
        launched = kernels[name].launches
        plain = fed if label == "ann" else dataclasses.replace(
            fed, selection_backend="oracle")
        want = select_phase(cpu.fed, plain, active=active.cpu(),
                            score_scale=staleness_discount(cpu.code_age,
                                                           0.5))
        same = (torch.equal(got.ids.cpu(), want.ids)
                and torch.equal(got.sel_mask.cpu(), want.sel_mask))
        out[label] = {"launches": launched, "equal_to_plain": same,
                      "masked_ranks": int((~want.sel_mask).sum())}
        if launched != 1 or not same:
            raise AssertionError(f"service route {label}: {launched} "
                                 f"launches of {name}, equal {same}")
    return out


def service_path(torch, kernels):
    """The continuous service on the card at the paper's mnist
    configuration (10 clients, mnist_cnn at full width): 4 periods of 4
    rounds, churn, heterogeneous gossip budgets and a fault plan
    (SERVICE, SERVICE_FAULTS), launch counts set to 0 just before the
    uninterrupted run and read just after (the LSH, one-shot selection
    and one-shot exchange kernels and no other). Then the same plan with
    a crash at period 2: the newest snapshot truncated after the first
    crash, resumed (falls back a period, crashes again at 2), resumed
    again to the end; final state, rounds and ledger payloads equal the
    uninterrupted run's bit for bit. Periods 0-1 on the CPU: every global
    round's selection (ids on every rank, masks) equal, accuracy within
    0.02 per round. The tiled and ANN routes through
    `select_phase(active=)` (`service_routes`). `serve_personalized` from
    the uninterrupted run's checkpoint: logits equal a direct
    `apply_client_model` on the card within 1e-5. Returns the uninterrupted
    run's launches."""
    import shutil
    import warnings

    from repro_torch.launch.fed import run_service_federation
    from repro_torch.launch.serve import serve_personalized
    from repro_torch.models.client import apply_client_model, client_template
    from repro_torch.configs.paper_models import mnist_cnn
    from repro_torch.service import CrashInjected
    work = ROOT / "build" / "chip_smoke_service"
    shutil.rmtree(work, ignore_errors=True)
    plain_dir, crash_dir = str(work / "uninterrupted"), str(work / "crash")

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    st_u, chain_u, hist_u = run_service_federation(
        "mnist", periods=4, ckpt_dir=plain_dir, faults=SERVICE_FAULTS,
        device="cuda", log=None, **SERVICE)
    wall_u = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    path = ("lsh_projection", "selection", "exchange")
    expect_launches(launches, path, set(kernels) - set(path), "service")
    for p in range(4):
        rounds = hist_u[4 * p:4 * p + 4]
        last = rounds[-1]
        emit({"phase": "service", "period": p,
              "s": sum(h["seconds"] for h in rounds),
              "round_s": [h["seconds"] for h in rounds],
              "active_frac": last["active_frac"],
              "participation_frac": [h["participation_frac"]
                                     for h in rounds],
              "acc": last["acc"], "mean_loss": last["mean_loss"],
              **{k: last[k] for k in FAULT_KEYS}})

    crashes, fallbacks, resume = [], 0, False
    while True:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                st_k, chain_k, hist_k = run_service_federation(
                    "mnist", periods=4, ckpt_dir=crash_dir,
                    faults=SERVICE_FAULTS + ",crash=2", resume=resume,
                    device="cuda", log=None, **SERVICE)
                crashed = False
            except CrashInjected as e:
                crashes.append(e.period)
                crashed = True
        fallbacks += sum("falling back" in str(w.message) for w in caught)
        if not crashed:
            break
        if len(crashes) > 2:
            raise AssertionError(f"the service crashed at {crashes}")
        if len(crashes) == 1:          # a crash mid-write of the newest
            newest = sorted(Path(crash_dir).glob("step_*.npz"))[-1]
            blob = newest.read_bytes()
            newest.write_bytes(blob[:len(blob) // 3])
        resume = True
    same = (same_tree(torch, st_k, st_u)
            and no_seconds(hist_k) == no_seconds(hist_u[8:])
            and [b.payload for b in chain_k.blocks]
            == [b.payload for b in chain_u.blocks])
    emit({"phase": "service_resume", "crashes": crashes,
          "snapshot_fallbacks": fallbacks, "bitwise_equal": same,
          "chain_verified": chain_k.verify_chain(),
          "fork_view": (Path(crash_dir) / "chain.fork0.json").exists()})
    if crashes != [2, 2] or fallbacks != 1 or not same:
        raise AssertionError("the resumed service differs from the "
                             "uninterrupted run or did not crash, fall "
                             "back and resume as planned")

    t0 = time.perf_counter()
    _, _, hist_c = run_service_federation(
        "mnist", periods=2, faults=SERVICE_FAULTS, device="cpu", log=None,
        **SERVICE)
    cpu_s = time.perf_counter() - t0
    for a, b in zip(hist_u, hist_c):
        if a["round"] % 4 == 0 and not (
                a["neighbor_ids"] == b["neighbor_ids"]
                and a["valid_mask"] == b["valid_mask"]):
            raise AssertionError(f"service round {a['round']}: the card's "
                                 "selection differs from the CPU's")
        if not abs(a["acc"] - b["acc"]) <= 0.02:
            raise AssertionError(f"service round {a['round']}: accuracy "
                                 f"{a['acc']} on the card, {b['acc']} on "
                                 "the CPU")
    routes = service_routes(torch, kernels, st_u)

    res = serve_personalized("mnist", ckpt_dir=plain_dir, requests=256,
                             device="cuda", log=None)
    from repro_torch.data import DATASETS
    x = torch.from_numpy(DATASETS["mnist"](seed=0).stacked()["x_test"])
    template = client_template(mnist_cnn())
    with torch.no_grad():
        direct = torch.stack([apply_client_model(
            template, {k: v[c] for k, v in st_u.fed.params.items()},
            x[c, t][None].cuda())[0]
            for c, t in zip(res["client_ids"], res["example_ids"])]).cpu()
    served = torch.from_numpy(res["logits"])
    err = (served - direct).abs().max().item()
    emit({"phase": "service_serve", "requests": res["requests"],
          "batches": res["batches"], "requests_per_s": res["requests_per_s"],
          "p50_latency_s": res["p50_latency_s"],
          "served_acc": res["served_acc"], "num_models": res["num_models"],
          "max_abs_err_vs_direct": err})
    torch.testing.assert_close(served, direct, rtol=1e-5, atol=1e-5)
    emit({"phase": "service_summary", "card_run_s": wall_u,
          "cpu_two_periods_s": cpu_s, "routes": routes,
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


# the federation dry run (`launch/fed.py:dryrun_fed_round`): the JAX
# default, CI's 1,024-client public tiled run, and the ANN route under
# attack with a gossip epoch
FED_DRYRUNS = (("default", dict(num_clients=256)),
               ("ci", dict(num_clients=1024, ref_mode="public",
                           tiling="tiled")),
               ("ann_attack", dict(num_clients=256, backend="ann",
                                   reselect_every=2, attack="lsh_cheat")))
FED_PATHS = {"default": ("lsh_projection", "selection", "exchange"),
             "ci": ("lsh_projection", "selection_tiled",
                    "exchange_streamed"),
             "ann_attack": ("lsh_projection", "selection_ann_grouped",
                            "exchange")}
PHASE_FNS = ("select_phase", "exchange_phase", "update_phase",
             "announce_phase")


class timed_phases:
    """Within the block, each protocol phase (`core.protocol`'s four
    functions, which the round programs look up at each call) runs
    between two device synchronisations and adds its wall seconds to
    `spent` (a sample of the round's split; the profiler cannot hold a
    256-client segment's events); `last` keeps the last (args, kwargs,
    result) of each phase named in `keep`."""

    def __init__(self, torch, keep=()):
        from collections import Counter

        from repro_torch.core import protocol
        self.torch, self.protocol, self.spent = torch, protocol, Counter()
        self.orig = {n: getattr(protocol, n) for n in PHASE_FNS}
        self.keep, self.last = keep, {}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.protocol, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.protocol, name, fn)

    def _timed(self, name, fn):
        def call(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.spent[name[:-len("_phase")]] += time.perf_counter() - t0
            if name in self.keep:
                self.last[name] = (args, kw, out)
            return out
        return call


def attention_names(params):
    """The names of every layer's wq, wk, wv in a flat client dict."""
    return [k for k in params if k.rsplit(".", 1)[-1] in ("wq", "wk", "wv")]


def attention_weights(torch, params):
    """Copies of every layer's wq, wk, wv (M, reps, ...)."""
    return {k: params[k].clone() for k in attention_names(params)}


def unit_busy_ms(torch, dr):
    """Device busy ms of each vmapped call of a period's exchange and
    update, each profiled over a few calls: the M clients' own forwards
    on their reference batches (no grad: flash through its vmap rule),
    the personal neighbour web over (M, N) gathered params, and one local
    step of all M clients (`batched_local_update`, its chunks
    included)."""
    from torch.func import vmap

    from repro_torch.core.protocol import batched_local_update, neighbour_web
    fed, params, data = dr.fed, dr.state.params, dr.data
    m = fed.num_clients
    n = min(fed.num_neighbors, m - 1)
    ids = (torch.arange(m, device="cuda")[:, None] + 1
           + torch.arange(n, device="cuda")) % m
    data_per = {k: data[k] for k in ("x_train", "y_train", "x_ref")}
    target = torch.zeros((m, fed.ref_batch, dr.cfg.vocab_size),
                         device="cuda")
    has = torch.ones((m,), dtype=torch.bool, device="cuda")
    n_local = data["x_train"].shape[1]
    idx = torch.randint(0, n_local, (m, 1, min(fed.local_batch, n_local)),
                        device="cuda")
    one_step = dataclasses.replace(fed, local_steps=1)

    def own():
        with torch.no_grad():
            vmap(dr.apply_fn)(params, data["x_ref"])

    def web():
        with torch.no_grad():
            neighbour_web(dr.apply_fn, params, data["x_ref"], ids)

    def step():
        batched_local_update(dr.apply_fn, dr.optimizer, one_step, params,
                             dr.state.opt_state, data_per, target, has,
                             batch_idx=idx)

    out = {"own_forwards": device_ms(own, iters=4)}
    if fed.ref_mode == "personal":
        out["neighbour_web"] = device_ms(web, iters=2)
    out["local_step"] = device_ms(step, iters=2) * fed.local_steps
    return out


# How far two 16-client segments from one state may lie apart: the
# worst leaf's relative L2 distance ||a - b|| / ||b|| of the new Adam
# moments m and v (after a first step m = (1 - b1) g and v = (1 - b2)
# g^2, so they carry the gradient) and of the update p1 - p0 (a first
# Adam step is ~lr * sign(g), so gradients near 0 flip entries of it);
# the share of the exchange's valid-mask entries that differ (the §3.5
# mask keeps the upper half by KL, so near-ties at its median may swap);
# the relative L2 distance of target_ref over the clients whose masks
# agree and of l_ij; mean_neighbor_loss's relative difference. Set from
# sound runs on an H100 (flash in the exchange against the naive
# attention, the card against the CPU, six seeds; largest readings m
# 0.0093, v 0.0113, update 0.158, masks 2 of 128, target_ref 0.0039,
# l_ij 1.7e-4, mean_neighbor_loss 2.9e-5: PERF.md, section 6)
# at 3-6 times the largest reading; each control exceeds one of them.
FED16_LIMITS = {"m": 0.05, "v": 0.05, "update": 0.5,
                "valid_mask_differ": 0.05, "target_ref": 0.02,
                "l_ij": 1e-3, "mean_neighbor_loss": 1.5e-4}


def segment_agreement(torch, a, b, p0):
    """The distances of FED16_LIMITS between runs `a` and `b`, each a
    (state, metrics, ExchangeResult) of one segment from params `p0`,
    and whether their has_target are equal."""
    def rel(x, y):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        return ((x - y).norm() / y.norm()).item()

    (sa, ma, ea), (sb, mb, eb) = a, b
    out = {part: max(rel(sa.opt_state[part][k], sb.opt_state[part][k])
                     for k in sb.opt_state[part]) for part in ("m", "v")}
    out["update"] = max(
        rel(sa.params[k].cpu().float() - p0[k].cpu().float(),
            sb.params[k].cpu().float() - p0[k].cpu().float()) for k in p0)
    same = ea.valid_mask.cpu() == eb.valid_mask.cpu()
    out["valid_mask_differ"] = 1.0 - same.float().mean().item()
    rows = same.all(-1)
    out["target_ref"] = rel(ea.target_ref.cpu()[rows],
                            eb.target_ref.cpu()[rows])
    out["l_ij"] = rel(ea.l_ij, eb.l_ij)
    out["mean_neighbor_loss"] = rel(ma["mean_neighbor_loss"],
                                    mb["mean_neighbor_loss"])
    out["has_target_equal"] = torch.equal(ea.has_target.cpu(),
                                          eb.has_target.cpu())
    return out


def over_limits(agree):
    """The keys of `agree` past FED16_LIMITS, and has_target if it
    differs."""
    return sorted([k for k, lim in FED16_LIMITS.items()
                   if not agree[k] <= lim]
                  + ([] if agree["has_target_equal"] else
                     ["has_target_equal"]))


def fed_dryrun_path(torch, kernels):
    """The federation with transformer clients (section 6b of the
    docstring): three dry-run configurations, each with its launches;
    attention trained at 256 clients; flash against the naive attention
    and the card against the CPU at 16, with controls; the path's
    kernels at its shapes. Each timed run is the first segment at its
    size (no warm-up of its own; `launch/fed.py --dryrun` times one
    after a warm-up)."""
    from repro_torch.core import protocol
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch.fed import (prepare_fed_dryrun, run_fed_dryrun,
                                        segment_flops)
    from repro_torch.models import attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    out, t_phase = {}, time.perf_counter()
    # 16 clients drawn on the CPU: one segment through flash and one
    # through the naive attention on the card, one on the CPU; the card's
    # first segments also warm the process for the timed runs below
    runs = {}
    for dev, impl in (("cuda", "auto"), ("cuda", "naive"), ("cpu", "auto")):
        dr = prepare_fed_dryrun(16, device=dev, draw_device="cpu")
        attention.set_attn_impl(impl)
        n0 = flash_attention.KERNEL.launches
        t0 = time.perf_counter()
        try:
            with timed_phases(torch, keep=("exchange_phase",)) as seen:
                state, metrics = dr.segment_fn(dr.state, dr.data)
        finally:
            attention.set_attn_impl("auto")
        runs[dev, impl] = (dr, (state, metrics[0],
                                seen.last["exchange_phase"][2]),
                           time.perf_counter() - t0,
                           flash_attention.KERNEL.launches - n0,
                           seen.last["exchange_phase"])
    (dc, rc, tc, lc, call), (_, rn, _, ln, _), (dp, rp, tp, lp, _) = (
        runs["cuda", "auto"], runs["cuda", "naive"], runs["cpu", "auto"])
    if (lc, ln, lp) != (2 * 2, 0, 0):
        raise AssertionError(f"16 clients: flash launched {(lc, ln, lp)} "
                             f"times (card, naive, CPU), not (4, 0, 0)")
    for label, ro in (("naive", rn), ("CPU", rp)):
        if not torch.equal(rc[1]["neighbor_ids"].cpu(),
                           ro[1]["neighbor_ids"].cpu()):
            raise AssertionError(f"16 clients: the card's ids differ from "
                                 f"the {label} run's")
    if segment_flops(dc) != segment_flops(dp):
        raise AssertionError("16 clients: card and CPU flops differ")
    p0 = dp.state.params
    agree = {"flash_naive": segment_agreement(torch, rc, rn, p0),
             "card_cpu": segment_agreement(torch, rc, rp, p0)}
    for pair in agree:
        over = over_limits(agree[pair])
        if over:
            raise AssertionError(f"16 clients, {pair}: {over} past "
                                 f"FED16_LIMITS: {agree[pair]}")
    # controls, each of which the comparisons must refuse: the card's
    # exchange with flash unmasked (a wrong attention), and the card's
    # segment with no gradient reaching wq, wk, wv (what the update
    # would give through a kernel without a backward) or with twice the
    # gradient (a wrong loss scale)
    args, kw, _ = call
    real = ops.gqa_flash_attention
    ops.gqa_flash_attention = lambda q, k, v, causal, **opt: real(  # noqa: E731
        q, k, v, causal=False, **opt)
    try:
        unmasked = protocol.exchange_phase(*args, **kw)
    finally:
        ops.gqa_flash_attention = real
    sc, mc, ec = rc
    att = set(attention_names(sc.params))
    frozen = sc._replace(
        params={k: p0[k].to(v.device) if k in att else v
                for k, v in sc.params.items()},
        opt_state={**sc.opt_state, **{
            part: {k: v * (k not in att) for k, v in sc.opt_state[part]
                   .items()} for part in ("m", "v")}})
    doubled = sc._replace(opt_state={
        **sc.opt_state, "m": {k: 2 * v for k, v in sc.opt_state["m"].items()},
        "v": {k: 4 * v for k, v in sc.opt_state["v"].items()}})
    controls = {}
    for name, run in (("flash_unmasked", (sc, mc, unmasked)),
                      ("attention_gradient_zeroed", (frozen, mc, ec)),
                      ("gradient_doubled", (doubled, mc, ec))):
        for pair, against in (("flash_naive", rn), ("card_cpu", rp)):
            over = over_limits(segment_agreement(torch, run, against, p0))
            if not over:
                raise AssertionError(f"16 clients: the control {name} "
                                     f"passes the {pair} comparison")
            controls[f"{name}_vs_{pair}"] = over
    emit({"phase": "fed_dryrun", "run": "flash_naive_cpu_16",
          "ids_equal": True, "flops": segment_flops(dc)["total"],
          "flash_launches": lc, "agreement": agree, "limits": FED16_LIMITS,
          "controls_refused_on": controls, "card_s": tc, "cpu_s": tp})
    del runs, dc, dp, rc, rn, rp, call, args, kw, unmasked, frozen, doubled
    laps = {"clients_16_s": time.perf_counter() - t_phase}

    for label, kw in FED_DRYRUNS:
        t0 = time.perf_counter()
        dr = prepare_fed_dryrun(**kw)
        torch.cuda.synchronize()
        set_up_s = time.perf_counter() - t0
        m, g = dr.fed.num_clients, kw.get("reselect_every", 1)
        # vmapped forward calls per exchange: the own forwards, and the
        # neighbour web in personal mode
        calls = 2 if dr.fed.ref_mode == "personal" else 1
        before = (attention_weights(torch, dr.state.params)
                  if label == "default" else None)
        for k in kernels.values():
            k.launches = 0
        with timed_phases(torch) as phases:
            report, state = run_fed_dryrun(dr, warmup=0, log=None)
        phases = phases.spent
        launches = {k: v.launches for k, v in kernels.items()}
        expect_launches(launches, FED_PATHS[label] + ("flash_attention",),
                        set(kernels) - set(FED_PATHS[label])
                        - {"flash_attention"}, f"fed_dryrun {label}")
        if launches["flash_attention"] != g * 2 * calls:
            raise AssertionError(
                f"fed_dryrun {label}: flash launched "
                f"{launches['flash_attention']} times, not {g * 2 * calls} "
                f"(2 layers x the exchanges' vmapped forward calls)")
        extra = {}
        if label == "default":
            # the update trains attention: every client's projections
            # moved in every layer
            after = attention_weights(torch, state.params)
            frozen = [(k, i) for k, v in after.items() for i in range(m)
                      if torch.equal(v[i], before[k][i])]
            if frozen:
                raise AssertionError(f"attention weights of {len(frozen)} "
                                     f"(leaf, client) pairs did not train, "
                                     f"e.g. {frozen[:3]}")
            busy = unit_busy_ms(torch, dr)
            est = g * sum(busy.values()) / 1e3
            extra = {"attention_trained": True, "unit_busy_ms": busy,
                     "device_busy_s_estimate": est,
                     "device_idle_share_estimate": 1.0 - est / report[
                         "wall_s"]}
            del before, after
        del dr, state
        torch.cuda.empty_cache()
        out[label] = {**report, "set_up_s": set_up_s, "launches": launches,
                      "phases_s": dict(phases), **extra}
        emit({"phase": "fed_dryrun", "run": label, **out[label]})

    laps["runs_s"] = time.perf_counter() - t_phase - laps["clients_16_s"]

    # the path's kernels at its shapes
    p = 1_640_448                      # reduced phi3, padded to 2,048
    checks = [
        ("lsh_projection", dict(m=m, p=p, bits=128),
         lambda m=m: check_lsh(torch, m, p, 128, gen)) for m in (256, 1024)
    ] + [
        ("selection", dict(m=256, bits=128, n=8),
         lambda: check_selection(torch, 256, 128, 8, gen)),
        ("selection_tiled", dict(m=1024, bits=128, n=8),
         lambda: check_selection_tiled(torch, 1024, 128, 8, gen)),
        ("selection_ann_grouped", dict(m=256, bits=128, n=8, kind="random",
                                       prefix_bits=10),
         lambda: check_selection_ann_grouped(torch, 256, 128, 8, gen)),
        ("exchange", dict(m=256, n=8, r=8, c=1024),
         lambda: check_exchange(torch, 256, 8, 8, 1024, gen)),
        ("exchange_streamed", dict(m=1024, n=8, r=8, c=1024),
         lambda: check_exchange_streamed(torch, 1024, 8, 8, 1024, gen)),
    ] + [
        ("flash_attention", dict(b=8, s=32, h=4, kv=1, dh=64, causal=True,
                                 dtype=str(dt)[6:]),
         lambda dt=dt: check_flash(torch, 8, 32, 32, 64, True, dt, gen,
                                   heads=(4, 1)))
        for dt in (torch.float32, torch.bfloat16)
    ] + [
        # the neighbour web's call at 256 clients: vmap over 256 clients
        # of vmap over 8 neighbours of 8 reference sequences
        ("flash_attention_vmapped", dict(outer=(256, 8), b=8, s=32, h=4,
                                         kv=1, dh=64, causal=True,
                                         dtype="bfloat16"),
         lambda: check_flash_vmapped(torch, (256, 8), 8, 32, 4, 1, 64,
                                     torch.bfloat16, gen)),
    ] + [
        # the own forwards' call: vmap over the clients of 8 reference
        # sequences (personal at 256, public at 1,024)
        ("flash_attention_vmapped", dict(outer=(m,), b=8, s=32, h=4, kv=1,
                                         dh=64, causal=True,
                                         dtype="bfloat16"),
         lambda m=m: check_flash_vmapped(torch, (m,), 8, 32, 4, 1, 64,
                                         torch.bfloat16, gen))
        for m in (256, 1024)
    ] + [
        ("flash_attention_vmapped", dict(contract_point=True, copies=2,
                                         dtype="float32"),
         lambda: flash_vmap_contract_and_taint(torch)),
    ]
    for name, shape, run in checks:
        res = run()
        emit({"phase": "kernel_check", "path": "fed_dryrun", "kernel": name,
              "shape": shape, **res})
        torch.cuda.empty_cache()
    laps["kernel_checks_s"] = (time.perf_counter() - t_phase
                               - laps["runs_s"] - laps["clients_16_s"])
    emit({"phase": "fed_dryrun", "run": "laps", **laps})
    return out


LEAK_FIXTURES = (("leak_announce_field.py", "taint-sink"),
                 ("leak_metric_tap.py", "taint-host-read"),
                 ("leak_served_private.py", "taint-sink"))


def timed_targets(torch, targets, run):
    """Seconds of `run(target)` over every target, the card synchronised
    before each clock read."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in targets:
        run(t)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def analysis_path(torch):
    """The analysis gate on the card (section 8 of the docstring); raises
    on any finding."""
    from repro_torch.analysis import taint
    from repro_torch.analysis.__main__ import check_fixture_file, run_gate
    from repro_torch.core import protocol
    from repro_torch.kernels import exchange

    t0 = time.perf_counter()
    gate = run_gate("cuda")
    gate_s = time.perf_counter() - t0
    bad = [str(f) for f in gate["findings"]]
    if bad:
        raise AssertionError("the analysis gate found:\n" + "\n".join(bad))
    if sorted(gate["contracts"]) != sorted(gate["entries"]) or any(
            c["launches"] < 1 for c in gate["contracts"].values()):
        raise AssertionError(f"contract launches: {gate['contracts']}")
    if gate["estimator_checks"] < 1:
        raise AssertionError("no shared-memory mirror was compared")
    path = {"lsh_projection", "selection", "exchange"}
    launched = {k for k, n in gate["taint_launches"].items() if n}
    if not path <= launched or not path <= set(gate["taint_kernels"]):
        raise AssertionError(
            f"the taint run launched {gate['taint_launches']} and fired the "
            f"wrapper rule of {gate['taint_kernels']}, not every kernel of "
            f"{sorted(path)}")

    # the wrapper rule is what labels a ctypes kernel's outputs
    t = taint._tiny("cuda")
    fed, apply_fn = t["fed"], t["apply_fn"]

    def probe(st, d):
        sel = protocol.select_phase(st, fed)
        own = torch.stack([apply_fn(protocol.client(st.params, i),
                                    d["x_ref"][i]) for i in range(t["m"])])
        return exchange.fused_exchange(own, own[sel.ids.long()],
                                       d["y_ref"], sel.sel_mask)

    before = exchange.KERNEL.launches
    run = taint.run_labelled("exchange-probe", probe, (t["state"], t["data"]),
                             (taint._fed_labels(t["state"]),
                              taint._data_labels(t["data"])))
    probe_labels = sorted(run.engine.of(run.out))
    if run.findings or exchange.KERNEL.launches - before != 1 or not {
            taint.SRC_PARAMS, taint.SRC_DATA} <= set(probe_labels):
        raise AssertionError(
            f"exchange probe: labels {probe_labels}, findings "
            f"{[str(f) for f in run.findings]}, launches "
            f"{exchange.KERNEL.launches - before}")

    leaks = {}
    for fname, rule in LEAK_FIXTURES:
        fs = check_fixture_file(
            str(ROOT / "tests" / "torch_analysis_fixtures" / fname), "cuda")
        leaks[fname] = [f.rule for f in fs]
        if leaks[fname] != [rule]:
            raise AssertionError(f"{fname}: {[str(f) for f in fs]}, not one "
                                 f"{rule}")

    # the 16 targets run plainly and under the check, both warm
    targets = taint.head_targets("cuda")

    def plain(target):
        fn, args, _ = target.build()
        fn(*args)

    found = []
    plain_s = timed_targets(torch, targets, plain)
    checked_s = timed_targets(
        torch, targets, lambda t: found.extend(taint.check_target(t)))
    if found:
        raise AssertionError(f"second taint run: {[str(f) for f in found]}")
    emit({"phase": "analysis", "gate_s": gate_s,
          "seconds": gate["seconds"], "findings": len(gate["findings"]),
          "entries": len(gate["entries"]),
          "contracts": gate["contracts"],
          "estimator_checks": gate["estimator_checks"],
          "taint_targets": len(gate["taint_targets"]),
          "taint_launches": gate["taint_launches"],
          "taint_kernels": gate["taint_kernels"],
          "host_ok": len(gate["host_ok"]), "probe_labels": probe_labels,
          "leak_findings": leaks, "targets_plain_s": plain_s,
          "targets_checked_s": checked_s,
          "taint_slowdown": checked_s / plain_s})


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # 1. hardware and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.launch.fed import run_federation

    resolve_device("cuda")               # strict f32: TF32 off
    kernels = kernel_objects()
    laps, clock = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the previous lap, kept under `name`."""
        now = time.perf_counter()
        laps[name], clock[0] = now - clock[0], now
        return laps[name]

    logs = build.build_all(kernels.values())
    emit({"phase": "build", "seconds": lap("build"),
          "ptxas": {name: ptxas_summary(log)
                    for name, log in logs.items()}})

    # 2. each kernel against its plain version on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main_shape = {}
    checks = [
        ("lsh_projection", dict(m=10, p=421_888, bits=256), True,
         lambda: check_lsh(torch, 10, 421_888, 256, gen)),
        ("lsh_projection", dict(m=16, p=4096, bits=256), False,
         lambda: check_lsh(torch, 16, 4096, 256, gen)),
        ("lsh_projection", dict(m=256, p=421_888, bits=256), False,
         lambda: check_lsh(torch, 256, 421_888, 256, gen)),
        ("lsh_projection", dict(m=35, p=12_288, bits=256), False,
         lambda: check_lsh(torch, 35, 12_288, 256, gen)),
        ("lsh_projection", dict(m=4096, p=12_288, bits=256), False,
         lambda: check_lsh(torch, 4096, 12_288, 256, gen)),
        ("lsh_projection", dict(m=65_536, p=12_288, bits=256), False,
         lambda: check_lsh(torch, 65_536, 12_288, 256, gen)),
        ("selection", dict(m=10, bits=256, n=9), True,
         lambda: check_selection(torch, 10, 256, 9, gen)),
        ("selection", dict(m=10, bits=256, n=9, ties=True), False,
         lambda: check_selection(torch, 10, 256, 9, gen, ties=True)),
        ("selection", dict(m=1024, bits=256, n=16), False,
         lambda: check_selection(torch, 1024, 256, 16, gen)),
        ("selection", dict(m=768, bits=512, n=16), False,
         lambda: check_selection(torch, 768, 512, 16, gen)),
    ] + [
        ("selection", dict(m=m, bits=256, n=n), False,
         lambda m=m, n=n: check_selection(torch, m, 256, n, gen))
        for m, n in ((4096, 16), (16_384, 16), (46_489, 16), (1024, 128),
                     (1024, 200))
    ] + [
        ("exchange", dict(m=10, n=9, r=64, c=10), True,
         lambda: check_exchange(torch, 10, 9, 64, 10, gen,
                                all_selected=True)),
    ] + [
        ("exchange", dict(m=m, n=n, r=r, c=c), False,
         lambda m=m, n=n, r=r, c=c: check_exchange(torch, m, n, r, c, gen))
        for m, n, r, c in ((8, 16, 64, 1024), (4096, 16, 64, 10),
                           (65_536, 16, 64, 10))
    ] + [
        ("selection_tiled", dict(m=10, bits=256, n=9), True,
         lambda: check_selection_tiled(torch, 10, 256, 9, gen)),
        ("selection_tiled", dict(m=10, bits=256, n=9, ties=True), False,
         lambda: check_selection_tiled(torch, 10, 256, 9, gen, ties=True)),
    ] + [
        ("selection_tiled", dict(m=m, bits=bits, n=16), False,
         lambda m=m, bits=bits: check_selection_tiled(torch, m, bits, 16,
                                                      gen))
        for m, bits in ((1024, 256), (2048, 256), (4096, 512), (65_536, 256))
    ] + [
        ("exchange_streamed", dict(m=10, n=9, r=64, c=10), True,
         lambda: check_exchange_streamed(torch, 10, 9, 64, 10, gen,
                                         all_selected=True)),
    ] + [
        ("exchange_streamed", dict(m=m, n=n, r=r, c=c), False,
         lambda m=m, n=n, r=r, c=c: check_exchange_streamed(torch, m, n, r, c,
                                                            gen))
        for m, n, r, c in ((8, 8, 32, 2048), (4, 16, 64, 1024),
                           (4, 8, 16, 4096), (8, 8, 32, 100_352))
    ] + [
        ("selection_ann", dict(m=10, bits=256, n=9, k=100), True,
         lambda: check_selection_ann(torch, 10, 256, 9, gen)),
        ("selection_ann", dict(m=10, bits=256, n=9, k=100, ties=True), False,
         lambda: check_selection_ann(torch, 10, 256, 9, gen, kind="ties")),
        ("selection_ann", dict(m=4096, bits=256, n=16, clustered=True), False,
         lambda: check_selection_ann(torch, 4096, 256, 16, gen,
                                     kind="clustered")),
        ("selection_ann", dict(m=65_536, bits=256, n=16, clustered=True),
         False, lambda: check_selection_ann(torch, 65_536, 256, 16, gen,
                                            kind="clustered")),
        ("selection_ann", dict(m=4096, bits=256, n=16, prefix_bits=0), False,
         lambda: check_selection_ann(torch, 4096, 256, 16, gen,
                                     prefix_bits=0, probes=0)),
    ] + [
        ("selection_ann_grouped", dict(m=m, bits=256, n=n, kind=kind,
                                       prefix_bits=pb),
         (m, kind) == (10, "random"),
         lambda m=m, n=n, kind=kind, pb=pb: check_selection_ann_grouped(
             torch, m, 256, n, gen, kind=kind, prefix_bits=pb,
             probes=8 if pb else 0))
        for m, n, kind, pb in ((10, 9, "random", 10), (10, 9, "ties", 10),
                               (4096, 16, "clustered", 10),
                               (65_536, 16, "clustered", 10),
                               (4096, 16, "random", 0))
    ] + [
        ("lsh_single", dict(p=p, bits=256), p == 421_888,
         lambda p=p: check_lsh_single(torch, p, 256, gen))
        for p in (421_888, 4096, 8192, 12_288)
    ] + [
        # the main shape at hash rows past 2^31, and ending 221,888 rows
        # past 2^32 (the row index wraps mid-vector, as uint32 does)
        ("lsh_single", dict(p=421_888, bits=256, row_offset=off), False,
         lambda off=off: check_lsh_single(torch, 421_888, 256, gen,
                                          row_offset=off))
        for off in ((1 << 31) + 12_345, (1 << 32) - 200_000)
    ] + [
        ("hamming", dict(m=m, bits=256), m == 10,
         lambda m=m: check_hamming(torch, m, 256, gen))
        for m in (10, 1024, 16_384)
    ] + [
        ("flash_attention", dict(n=n, sq=sq, sk=sk, dh=dh, causal=causal,
                                 dtype=str(dt)[6:], **extra),
         extra == {} and (n, sq, dh, dt) == (96, 2048, 128, torch.float32),
         lambda n=n, sq=sq, sk=sk, dh=dh, causal=causal, dt=dt, extra=extra:
         check_flash(torch, n, sq, sk, dh, causal, dt, gen, **extra))
        for n, sq, sk, dh, causal, dt, extra in (
            (96, 2048, 2048, 128, True, torch.float32, {}),
            (96, 2048, 2048, 128, True, torch.bfloat16, {}),
            (2, 512, 512, 128, True, torch.float32, {}),
            (1, 1024, 512, 64, True, torch.float32, {}),
            (2, 256, 512, 128, False, torch.float32, {}),
            (3, 1000, 1000, 128, True, torch.float32, {}),
            (2, 512, 512, 128, True, torch.bfloat16, {}),
            (2, 512, 512, 256, True, torch.float32, {}),
            (4, 2048, 2048, 128, True, torch.float32,
             {"heads": (24, 8)}),
            (4, 1500, 1500, 64, False, torch.float32,      # whisper encoder
             {"heads": (12, 12)}),
            (4, 2048, 2048, 128, True, torch.float32,      # grok-1's GQA
             {"heads": (48, 8)}))
    ]
    # the service's churn: -inf score columns (departed clients) for the
    # selection kernels, at the main shape and the largest M each is
    # checked at; rows with N-1 of N and all ranks masked for both
    # exchange kernels
    checks += [
        ("selection", dict(m=m, bits=256, n=n, departed=d), False,
         lambda m=m, n=n, d=d: check_selection(torch, m, 256, n, gen,
                                               departed=d))
        for m, n, d in ((10, 9, 0.3), (1024, 200, 0.9), (46_489, 16, 0.3))
    ] + [
        ("selection_tiled", dict(m=m, bits=256, n=n, departed=0.3), False,
         lambda m=m, n=n: check_selection_tiled(torch, m, 256, n, gen,
                                                departed=0.3))
        for m, n in ((10, 9), (65_536, 16))
    ] + [
        ("selection_ann_grouped", dict(m=m, bits=256, n=n, kind=kind,
                                       prefix_bits=10, departed=0.3), False,
         lambda m=m, n=n, kind=kind: check_selection_ann_grouped(
             torch, m, 256, n, gen, kind=kind, departed=0.3))
        for m, n, kind in ((10, 9, "random"), (65_536, 16, "clustered"))
    ] + [
        (name, dict(m=m, n=n, r=r, c=c, masked=True), False,
         lambda fn=fn, m=m, n=n, r=r, c=c: fn(torch, m, n, r, c, gen,
                                              masked=True))
        for name, fn, big in (
            ("exchange", check_exchange, (4096, 16, 64, 10)),
            ("exchange_streamed", check_exchange_streamed, (8, 8, 32, 2048)))
        for m, n, r, c in ((10, 9, 64, 10), big)
    ]
    for name, shape, is_main, run in checks:
        res = run()
        emit({"phase": "kernel_check", "kernel": name, "shape": shape,
              "main_path_shape": is_main, **res})
        if is_main:
            main_shape[name] = res
        torch.cuda.empty_cache()
    lap("kernel_checks")

    # 3. the main paths: one-shot kernels, plain versions, tiled kernels,
    # ANN selection; then the per-client code and the unfused Eq. 6-8
    oneshot = ONESHOT
    tiled = ("lsh_projection", "selection_tiled", "exchange_streamed")
    ann_path = ("lsh_projection", "selection_ann_grouped", "exchange")
    hist, launches, state = run_main_path(run_federation, kernels,
                                          backend="kernel")
    expect_launches(launches, oneshot, set(kernels) - set(oneshot),
                    "one-shot")
    hist_o, _, _ = run_main_path(run_federation, kernels, backend="oracle")
    expect_same_run(hist_o, hist, "oracle")
    hist_t, launches_t, _ = run_main_path(run_federation, kernels,
                                          backend="kernel", tiling="tiled")
    expect_launches(launches_t, tiled, set(kernels) - set(tiled), "tiled")
    expect_same_run(hist_t, hist, "tiled")
    hist_a, launches_a, _ = run_main_path(run_federation, kernels,
                                          backend="ann")
    expect_launches(launches_a, ann_path, set(kernels) - set(ann_path), "ann")
    if (launches_a["selection_ann_grouped"], launches_a["selection_ann"]) \
            != (2, 0):
        raise AssertionError(
            "the ann run launched the grouped ANN selection "
            f"{launches_a['selection_ann_grouped']} times, not 2, and the "
            f"per-row one {launches_a['selection_ann']} times, not 0")
    expect_same_run(hist_a, hist, "ann", id_sets=True)
    check_ann_round0_order(torch, hist_a)
    launches_c = client_codes_and_distances(torch, state, kernels)
    for name in ("selection_tiled", "exchange_streamed"):
        launches[name] = launches_t[name]
    launches["selection_ann_grouped"] = launches_a["selection_ann_grouped"]
    for name in ("lsh_single", "hamming"):
        launches[name] = launches_c[name]
    check_auto_tiling_at_scale(torch, gen)
    check_auto_ann_at_scale(torch, gen)
    lap("main_paths")

    names = (*LSH_NAMES, "fused_select_kernel",
             "fused_exchange_kernel", "select_tiled_kernel",
             *STREAMED_EXCHANGE_NAMES, "select_ann_grouped_kernel")
    profiles = {}
    for backend, tiling in (("kernel", "oneshot"), ("kernel", "tiled"),
                            ("ann", "auto")):
        profiles[backend, tiling] = profile_round(
            run_federation, names, tiling=tiling, backend=backend)
        emit({"phase": "profile", **profiles[backend, tiling]})
    lap("profiles")

    # 4. the paper's threats and comparisons on the card
    attack_path(run_federation, kernels, (
        ("one-shot", oneshot, dict(backend="kernel", tiling="oneshot")),
        ("tiled", tiled, dict(backend="kernel", tiling="tiled")),
        ("ann", ann_path, dict(backend="ann"))))
    lap("attack")
    baselines_path(kernels)
    lap("baselines")

    # 5. LM serving: Minitron-4B at full width, prefill + greedy decode
    launches["flash_attention"] = serve_path(torch, kernels)[
        "flash_attention"]
    lap("serve")
    torch.cuda.empty_cache()
    families_path(torch, kernels)
    lap("families")

    # 6. LM training: card against CPU, Minitron-4B at full width,
    # checkpoints; no kernel lies on this path
    train_path(torch, kernels)
    lap("train")
    torch.cuda.empty_cache()

    # 6a. the other families' training: reduced card against CPU,
    # recurrentgemma-2b, whisper-small and xlstm-350m at full width,
    # kimi-k2 at published widths cut to 1 layer of 16 experts
    train_families_path(torch, kernels)
    lap("train_families")
    torch.cuda.empty_cache()

    # 6b. the twins of the JAX package's smoke scripts and examples, each
    # through its kernels
    examples_path(torch, kernels)
    lap("examples")
    torch.cuda.empty_cache()

    # 7. sharding: sharded LSH codes at Minitron-4B's parameter count and
    # expert-parallel MoE over 4 gloo ranks on this card, specs placed on
    # a (1, 1) NCCL mesh, the dryrun on meta
    emit({"phase": "main_path_launches", "run": "sharding",
          **sharding_path(torch, kernels)})
    lap("sharding")

    # 7a. the tensor-parallel forward: Minitron-4B, phi3-medium-14b and
    # recurrentgemma-2b at full width (depth cut) on a (1, 4) mesh of 4
    # gloo ranks on this card, against the unsharded forward
    torch.cuda.empty_cache()
    sharding_tp_path(torch, kernels)
    lap("sharding_tp")

    # 7b. the federation with transformer clients: the dry run's period
    # at 256 and 1,024 clients, attention trained, flash launches, card
    # against CPU, the path's kernels at its shapes
    torch.cuda.empty_cache()
    dry = fed_dryrun_path(torch, kernels)
    lap("fed_dryrun")
    mnist = profiles["kernel", "oneshot"]
    emit({"phase": "client_axis", "card": smi,
          "mnist_round_s": hist[1]["seconds"],
          "mnist_round_profiled_s": mnist["wall_ms"] / 1e3,
          "mnist_idle_share": mnist["device_idle_share"],
          "mnist_phases_host_ms": mnist["phases_ms"],
          "fed_dryrun_period_s": {"256": dry["default"]["wall_s"],
                                  "1024": dry["ci"]["wall_s"]},
          "fed_dryrun_peak_gb_1024": dry["ci"]["peak_bytes"] / 1e9,
          "unit_busy_ms": dry["default"]["unit_busy_ms"],
          "device_idle_share_estimate_256": dry["default"][
              "device_idle_share_estimate"],
          "fed_dryrun_phase_s": laps["fed_dryrun"]})

    # 8. the analysis gate: contract launches, shared-memory mirrors, the
    # taint targets through the kernels, the leak fixtures
    analysis_path(torch)
    lap("analysis")

    # 9. the continuous service: churn, gossip budgets, faults, a crash
    # and a resume, then personalized serving (last: it holds cuDNN to
    # deterministic algorithms for the rest of the process)
    service_path(torch, kernels)
    lap("service")
    emit({"phase": "seconds", "card": smi, **laps,
          "total": time.perf_counter() - t_start})

    # 10. every ported kernel
    meta = {
        "lsh_projection": ("src/repro_torch/kernels/csrc/lsh_projection.cu",
                           "src/repro/kernels/lsh_projection.py:134"),
        "selection": ("src/repro_torch/kernels/csrc/selection.cu",
                      "src/repro/kernels/selection.py:180"),
        "exchange": ("src/repro_torch/kernels/csrc/exchange.cu",
                     "src/repro/kernels/exchange.py:153"),
        "selection_tiled": ("src/repro_torch/kernels/csrc/selection.cu",
                            "src/repro/kernels/selection.py:271"),
        "exchange_streamed": (
            "src/repro_torch/kernels/csrc/exchange_streamed.cu",
            "src/repro/kernels/exchange.py:309"),
        "selection_ann_grouped": ("src/repro_torch/kernels/csrc/selection.cu",
                                  "src/repro/kernels/selection.py:398"),
        "lsh_single": ("src/repro_torch/kernels/csrc/lsh_projection.cu",
                       "src/repro/kernels/lsh_projection.py:92"),
        "hamming": ("src/repro_torch/kernels/csrc/hamming.cu",
                    "src/repro/kernels/hamming.py:52"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:90"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[name],
         "max_abs_err": main_shape[name]["max_abs_err"],
         "ms": main_shape[name]["kernel_ms"],
         "plain_ms": main_shape[name]["plain_ms"],
         "bound_ms": main_shape[name]["bound_ms"],
         "bound_by": main_shape[name]["bound_by"],
         "library_ms": main_shape[name]["library_ms"]}
        for name in meta]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
