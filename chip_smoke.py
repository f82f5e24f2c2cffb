#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from src/repro_torch/kernels/csrc
with nvcc, then:

  1. card:    prints the device name and nvidia-smi's name and power limit;
  2. kernels: holds fused_grad (all four losses), tsgram and gemm against
              their plain torch versions at the main path's shapes, A of
              2^21 x 1024 in f32 and again in bf16 storage, and times each
              (CUDA events, warmed, median of REPS launches) beside its
              plain version, one PyTorch library call where there is one,
              and the card's bound for the same work (tsgram's f32 bound
              is its route's, three TF32 tensor-core products a product;
              the f32 CUDA-core bound is printed beside it; gemm's is its
              route's, TF32 tensor-core products); tsgram and gemm also
              on A's ragged view (2^21 x 1023 starting one element into
              A's storage), bit for bit against its aligned copy;
  3. svd:     api.svd in Gram mode, k = 16, on the f32 A; singular values
              against the float64 Gram's eigenvalues, U's orthogonality, and
              the A-pass count;
  4. solves:  api.solve for quad/gra, quad/acc_rb and logistic/gra on the
              same A with L0 = sigma_1^2 from phase 3; the quad objectives
              against the float64 normal-equations optimum, the logistic
              history for descent, and every solve's A-passes against the
              fused_grad launches it made.
  5. serve:   one SolverServer(slots=8) on the same A answers 16 quad/gra
              requests (two waves through 8 slots), 8 quad/acc_rb and 8
              logistic/lbfgs requests, and one SvdRequest(k=16,
              mode="auto") of a wide A_w (2^18 x 16384, a decaying
              spectrum) that must take the randomized mode; two requests
              per group are served again one at a time (slots=1), and
              one exact SimilarityRequest on A.  Quad answers against
              their float64 optima, group against serial answers, the
              SVD's sigma against a float64 subspace iteration, the
              similarities against float64 cosines, and fused_grad_multi
              launches against the server's A-passes, request by request.
  6. sparse:  S = 2^22 x 2^14 in 32 x 32 blocks, 16 a block-row, block
              columns from a Zipf(1) law, built on the card (the dense
              matrices freed first): api.svd(k=16, mode="auto") takes the
              Lanczos mode (bsr_matvec + bsr_rmatmul an operator call,
              bsr_matmul for U), checked by float64 residuals
              ||S^T S v - sigma^2 v|| and the factors' orthogonality; then
              api.solve quad/gra fused (fused_grad_bsr) and unfused
              (bsr_matvec + bsr_rmatmul), logistic/gra fused, and quad/gra
              on S's int8 copy (bsr_matvec + bsr_rmatmul), with the float64
              relative gradient of each quad answer, fused against unfused,
              and each solve's launches against its A-passes.
  7. sparse serve: one SolverServer(slots=8) on S answers 16 quad/gra, 8
              quad/acc_rb and 8 logistic/lbfgs requests (iteration caps
              SPARSE_SERVE_ITERS), a sampled SimilarityRequest (threshold
              0.5, default gamma) and an exact one on S_sim = 2^20 x 2^12
              (bs 32, ell 16, Zipf(1) over 128 block columns, 64 planted
              column pairs of cosine near 0.9), and an exact one on S_sim
              densified as a RowMatrix.  After the path's counts are read:
              each served objective against a float64 evaluation at its x,
              the gra answers' float64 relative gradient against
              SERVE_REL_GRAD_LIMIT, the solves again one at a time
              (slots=1: every gra request, two of each other group) and the
              acc_rb requests through api.solve; DIMSUM's gamma, p and
              variance against float64 formulas, its planted pairs against
              the DIMSUM error bounds, both exact answers against the
              float64 cosines of the whole matrix and against each other,
              and fused_grad_bsr_multi launches against the server's
              A-passes.  Then bsr_rmatmul on a 512-column strip of S_sim
              and of S (a strip of the sparse Gram) and tsgram on S_sim's
              dense copy against their plain versions.
  9. front door (after phase 7, once its matrices are freed): (a)
              api.minimize on the four make_problem problems at their
              default sizes (10000 x 1024; logistic 10000 x 250) through
              every method, fused="auto", the default caps, each final
              objective within FIG1_CPU_TOL of the same call on the CPU,
              the linear runs' gaps to the float64 optimum printed, the
              backtracking methods' histories descending, and every fused
              run's A-passes equal to its fused_grad launches; (b)
              `linear` at 2^20 x 1024 through gra, acc_rb and lbfgs, each
              stopping before its cap within 1e-5 of the float64 optimum,
              with its wall ms and the on-device L's; (c) solve_lasso on
              the same A with 10 planted coefficients, its objective
              against a float64 evaluation at its x and at the planted x;
              (d) solve_smoothed_lp on a dense M_LP x N_LP RowMatrix
              (LP_CONTINUATIONS, LP_ITERS) held to tests/test_tfocs.py's
              bounds; (e) a 2^18 x 2^14 CoordinateMatrix of 2^27 entries
              filling 32 x 32 blocks (Zipf(1) block columns): Lanczos
              SVDs (k = 16) of it (segment-sum products, the same bits
              every call) and of its to_sparse_row_matrix(bs=32)
              (bsr_matvec + bsr_rmatmul, bsr_matmul for U), sigma apart
              by at most 1e-4, float64 residuals, the conversion's block
              count; (f)
              BlockMatrix.multiply of two 8192 x 8192 f32 matrices (one
              gemm launch) within 1e-4 of float64, timed beside torch.mm
              and its route's bound, and the Lanczos SVD of an
              IndexedRowMatrix over phase 3's A (made again from its
              seed) against the Gram sigma; (g) api.compute_svd against
              api.svd bit for bit on that A, and serve.main at 2^20 x
              1024 with 16 requests, its group A-passes equal to its
              fused_grad_multi launches.
  8. lm:      greedy generation (repro_torch.launch.serve_llm.generate:
              prefill, then 31 decode steps) of LM_BATCH = 4 prompts of
              2048 tokens on llama3.2-3b (28 layers, GQA 24:8, bf16) and
              then falcon-mamba-7b (64 Mamba1 layers, bf16 weights, f32
              scan), each at full width and depth with weights drawn from
              a seed, the earlier phases' matrices freed first.  The
              prefill launches flash_attention (llama; bf16, so its
              tensor-core variant, counted apart from the f32 one) or
              selective_scan (mamba) once a layer and a decode step
              none.  Then each
              kernel against its plain version on layer 0's real inputs
              (flash_attention in bf16 and f32, bf16 at S = 2049, and
              bf16 causal with 2048 queries against 2049 keys;
              selective_scan's y and final state at S = 2048 and 2049),
              timed beside SDPA (attention) and its bound; and prefill
              against decode: the last-position logits of a prefill of
              S + 1 tokens against a prefill of S and one decode step, at
              full size in bf16 and at full width and 4 layers in f32.
              Then the moe family (MLA + MoE) at full width, depth cut
              to 4 (LM_MOE_LAYERS): deepseek-v2-236b (1 dense + 3 MoE
              layers) and deepseek-v3-671b (3 dense + 1 MoE, its MTP
              block's weights made), each alone: generate as above with
              the share of token-expert pairs dropped past capacity
              (capacity_factor 1.25), flash_attention once a layer at
              head dim 192 (the materialized q·k width) and a decode step
              launching none, the kernel against its plain version on
              layer 0's real materialized q, k and zero-padded v (bf16
              and f32 at S = 2048, bf16 at 2049, 2048 queries against
              2049 keys), timed beside SDPA (its longest device kernel
              named) and the bound; prefill against decode in both MLA
              decode modes, where no pair can be dropped (PVD_CAPACITY_
              FACTOR: capacity is sized over B·S tokens in prefill and B
              in decode, so drops part the two; the reading at 1.25 is
              recorded): bf16 on 4 prompts at capacity factor 8 with no
              pair dropped, held on the rows whose last token went to
              the same experts in both at every MoE layer (a router gap
              of 1e-5 flips under bf16 rounding; every row recorded), f32
              at 4 layers (MTP left out) on one prompt of 1025 tokens at
              a capacity of every token, held on every row; and on v2 a
              second generate in materialize decode mode, row 0's tokens
              printed beside the absorbed run's.  Last, qwen3-4b (36
              layers), qwen2.5-32b, deepseek-coder-33b and
              llava-next-34b (4 layers each; llava with its 2880 patch
              embeddings through generate's frontend_embeds in a prompt
              of 4096), one generate each, flash_attention once a
              layer.  Then the last two families at full width and
              depth (run_lm_families): zamba2-1.2b (38 Mamba2 layers in
              6 groups led by the shared attention block, and a tail of
              2; bf16) launches selective_scan at N = 64 once a Mamba2
              layer and flash_attention (D = 64, causal) once a group a
              prefill; seamless-m4t-large-v2 (24 encoder + 24 decoder
              layers, bf16, 2048 frames) launches flash_attention three
              times a layer pair (the encoder's self-attention and the
              cross-attention non-causal, 48 of the 72); decode steps
              launch none.  selective_scan at N = 64 against plain on
              zamba2's layer-0 inputs (S = 2048, from a nonzero state,
              S = 2049), timed beside its bound and the reference's
              chunked SSD form in plain torch at the same shape;
              flash_attention at D = 64 causal (the shared block) and
              non-causal (the encoder's layer 0, and the cross-attention
              of 2048 queries against 1500 encoder frames) against plain
              in bf16 and f32, timed beside SDPA; prefill against decode
              in bf16 at full size and in f32 (zamba2 at 8 layers, one
              group and the tail; seamless at full depth on 1500 frames
              against a prompt of 2049).
  10. planner (after phase 8, every earlier path done; about 10 s):
              with an empty autotune cache (REPRO_TORCH_AUTOTUNE_CACHE, a
              fresh temporary directory for the run) and the built-in H100
              model, autotune.resolve(tune="auto") equals today's launch at
              every shape the paths ran (gemm's tile width; every other
              kernel has one launch and resolves to no choice); at
              efficiency 1 the model's time of each kernel row is its bound within 1%;
              plan().explain() for grad and gram at A, sparse_matmul and
              bsr_bs at S, svd for A, A_w and S; quantize="auto" on S at
              tol 1e-3 picks int8 and dispatch="auto" the BlockELL
              kernels; gemm's output tile swept at A x 16 and A_w x 26
              (CUDA events, each candidate against plain), the winner
              recorded and the next resolve a memo hit; quad/gra on A
              (cap PLAN_ITERS) in f32 and bf16 at tol 1e-5 (bf16's
              fused_grad launches on a bf16 A, its float64 objective
              within 100 x tol of f32's) and precision="auto" at 1e-4
              (reported) and 1e-9 (f32); phase 5's requests through a
              SolverServer budgeted at two group passes, every one
              finished; then planner.calibrate() over records of the
              kernel medians phases 2, 5, 6 and 8 took: the fitted
              efficiencies and launch cost, error() no larger after the
              fit, and every printed decision that flips.
Phase 2 also holds fused_grad_multi (k = 1, 8, 16, 40, all four losses,
f32 and bf16 storage, one launch a call, slot independence of the other
slots and of the slot count, zero-weight slots) on A, and randsketch (r = 26, f32 and bf16,
on A_w and on its ragged view of N_W - 1 columns starting one element into
its storage, each against plain, bit-stable, the view against its aligned
copy, and timed),
fused_grad at A_w's width (the kernel's unstaged path) on A_w, and gemm at
its serving shapes (Y = A_w Z with Z of 26 columns, and TSQR's 2^18 x 26
times 26 x 26, two runs the same bits, timed beside torch.mm), against
their plain versions, and the four block-sparse kernels (f32, bf16 and
int8 storage; bsr_matmul at nx = 16, its columns at nx = 1 and 8 bit for
bit those of nx = 16 and unchanged when X's other columns change,
bsr_rmatmul at nx = 1 and 16, its columns likewise, beside torch's BSR
product of a transpose stored once and its route's bound (TF32 tensor-core
products; the f32 FMA bound recorded beside it as fma_bound_ms),
fused_grad_bsr for every loss) and fused_grad_bsr_multi (k = 1, 8, 16, 40,
every loss, f32 and bf16 storage, one launch a call, slot independence;
the int8 composition at k = 8, its slot bits too) on S, just before
phase 6.  After the build it prints each multi-slot kernel's,
flash_attention's, randsketch's, tsgram's, bsr_matmul's, bsr_rmatmul's,
gemm's and selective_scan's registers and spill bytes from ptxas, and
fails if a flash_attention kernel (both variants, every head dim, 192
included) spills or has its wgmmas serialized by ptxas, or if a
randsketch, tsgram, bsr_matmul, bsr_rmatmul, gemm or selective_scan kernel
spills or has them serialized.  fused_grad is
fused_grad_multi's kernel with one slot, and fused_grad_bsr
fused_grad_bsr_multi's.  Phase 5 also serves an exact SimilarityRequest on
A, held to the float64 cosines of phase 3's Gram.
  11. cluster (after phase 10 with every earlier matrix freed;
              about 60 s): phase 3's A (2^21 x 1024) and phase 6's S,
              each drawn whole from its seed on every rank, their rows
              split over the ranks of a torch.distributed group started
              by repro_torch.launch.mesh.spawn: a one-rank NCCL group,
              then (one card) two gloo ranks sharing the card or (more
              cards) NCCL, one rank a card.  On each: fused_grad at a
              fixed x, the Gram eager and at chunks=4 (randsketch a
              segment), the strip cast to bf16, e4m3 and e5m2 by each
              rank and on each copy the chunked Gram and the chunked
              fused gradient (randsketch on the strip's column segments,
              the row residual in f32) against eager on the same strip
              (CLUSTER_TOL), api.svd in Gram and randomized mode (k = 16),
              TSQR, quad/gra and quad/acc_rb at tol 0 (every iteration
              run), quad/gra in f32 and precision="psum8" (the int8 wire),
              and quad/gra fused on S's strips.  The multi-rank group
              against the one-rank group: f, g and z (CLUSTER_TOL), the
              Grams, sigma, R, the objectives and A-passes; every rank
              ends with the same x; each rank's fused_grad (fused_grad_bsr)
              launches equal its A-passes; psum8's objective within
              100 x tol of f32's.  Prints the backend, world size and
              each rank's device, and each all_reduce's median ms with
              its payload beside the card's name and power limit.
  12. elastic (after phase 11; about 60 s): phase 3's A drawn
              again from its seed, through the elastic executor
              (core/optim/elastic, quad/gra at tol 0, ELASTIC_ITERS
              iterations): a clean solve_elastic; the same solve
              checkpointed every ELASTIC_EVERY iterations, abandoned at
              ELASTIC_CUT and resumed (x bit for bit the clean one's); a
              failed pass and a NaN smooth value, each retried (x bit for
              bit); api.solve with deadline_s (degraded="deadline", a
              finite best iterate); a SolverServer(elastic_factory=) of
              ELASTIC_SERVE requests with a straggler wrapped around its
              group, against the same requests through a plain server,
              re-meshed at least once; then, in a two-rank group (gloo on
              one card, NCCL one rank a card where there are two), a
              straggler re-mesh on A's strips and a device loss on phase
              6's S (fused_grad_bsr_multi), each rank drawing the matrix
              whole and keeping its strip, the dropped rank returning
              with info["dropped"].  The survivor on A is held to the
              one-rank clean solve (ELASTIC_CLUSTER, ELASTIC_TOL); on S,
              bit for bit to the one-rank solve started from the
              two-rank clean solve's iterate and L at the loss, with the
              backtracking steps of both runs printed beside those of
              the one-rank clean solve (see ELASTIC_LOSS).  Each case's
              fused_grad_multi (fused_grad_bsr_multi) launches equal its
              A-passes; prints each case's wall ms, the re-mesh's and the
              checkpoints' ms beside the card's name and power limit.
  13. fp8 (after phase 12; about 70 s): first randsketch on A_w
              (phase 5's seed) cast to each fp8 type, r = 26, against
              randsketch_plain (TOL["sketch"]), timed beside plain and
              mm(a.T, q) on bf16 copies, its bound one read of A or two
              TF32 products; then phase 3's A drawn again from its seed
              and, for float8_e4m3fn and then float8_e5m2 (FP8_TYPES),
              cast on the card (kernels/dtypes.cast, 2.15 GB), bit for
              bit the same helper's cast on the CPU, chunk by chunk, and
              on the type's edge values (FP8_EDGES: e4m3's ±448, the
              midpoint 464 and past it, e5m2's 57344, the overflow
              midpoint 61440 and past it, infinities, NaN, -0,
              subnormals); rows 1-4 on it against their plain versions
              (fused_grad every loss; fused_grad_multi k = 8 every loss
              and k = 40, slot 0 the one-slot launch's bits; tsgram; gemm
              at N = 16 with f32 and fp8 out, fp8 within one step), timed
              beside plain, the bound at the card's rate for the operand
              types (fp8 tensor cores for the Gram, two TF32 products for
              fp8 A against f32) with the bound of each kernel's own
              route beside it (f32 FMA, 16-bit mma.sync, TF32), and the
              row's bf16 library call on bf16 copies (torch._scaled_mm
              takes neither layout); tsgram and gemm on A's ragged fp8
              view bit for bit its aligned copy; the model at efficiency
              1 against each route's bound.  Then the type's main path
              (counts zeroed just before, read just after): the Gram SVD
              (k = 16, mode "auto": sigma within 1e-4 of the float64 Gram
              of the dequantized A, 2 A-passes, U in A's type within one
              step of the plain path's), quad/gra (200), quad/acc_rb
              (100) and logistic/gra (300) (FP8_SOLVES; quad gaps within
              1e-5 of the dequantized optimum before their caps, the
              logistic gap within 1e-5 of the float64 Newton optimum,
              fused_grad launches equal A-passes), a SolverServer(slots=8)
              of 8 quad/gra, 4 quad/acc_rb and 4 logistic/lbfgs requests
              (every answer within 1e-5 of its float64 optimum,
              fused_grad_multi launches equal its A-passes, two requests
              again at slots=1 the same bits), RowMatrix.sketch (r = 26,
              one gemm launch; Y in A's type within one step of plain)
              and project of A onto Y (one randsketch launch, Q in A's
              type; within TOL["sketch"] of plain).  Last, matvec, the
              Lanczos and randomized SVDs, TSQR, DIMSUM and logistic/acc
              each raise TypeError with no launch.  Rows 1-5 of the
              kernels line gain "e4m3" and "e5m2".
  14. mesh (last, after phase 13; about 60 s): four ranks on a
              ("data", "model") = (2, 2) mesh (gloo ranks sharing the
              card; NCCL one rank a card where there are four).  Phase 9
              (f)'s two 8192 x 8192 f32 matrices drawn whole on every rank
              from their seed, each rank keeping its 4096 x 4096 tile:
              BlockMatrix.multiply by SUMMA (two all_gathers, one gemm
              launch a rank) within MESH_TOL of the one-device product,
              matvec, rmatvec and their model-sharded forms and the norm
              against the one-device BlockMatrix's, the transpose's tiles
              bit for bit; phase 9 (e)'s CoordinateMatrix of 2^27 entries
              sharded by position over "data": its products against the
              one-device matrix's and its Lanczos SVD (k = 16) against
              phase 9's sigma; gemm at the SUMMA shape against its plain
              version, timed beside torch.mm and its bound; each step's
              and each all_gather's host-clock ms beside the card's name
              and power limit.  Then the survivor path: row shard 1
              dropped (train/elastic.survivor_mesh, a (1, 2) mesh of
              ranks 0 and 1), BlockMatrix made again there, SUMMA (one
              gemm launch a rank) and the vector products against the
              one-device matrix, the CoordinateMatrix made again there,
              its products against one device's and its Lanczos sigma
              against phase 9's.
Phase 11 also serves, on every rank of each group, CLUSTER_SLOTS quad
requests a group on A's strips (gra, acc, acc_rb: fused_grad_multi) and a
gra group on S's strips (fused_grad_bsr_multi) at tol 0, and runs an acc
ElasticGroup on A through a seeded device loss (CLUSTER_LOSS: a re-mesh
onto the survivors, the lost shard's rank dropped); each held to the
one-rank group's answers (CLUSTER_SERVE_TOL, A-passes equal, x the same
bits on every rank, launches equal to A-passes).
Phases 3 and 4 are one main path, phases 5, 6 and 7 one each, phase 9
seven (fd_* in PATHS), phase 11 one on every rank, phase 12 one a case,
phase 13 one a type (PATHS["e4m3"], PATHS["e5m2"]), phase 14 two on
every rank (the mesh and its survivors) and phase 8 one a model: every
launch count
is set to 0 just before each and read just after it (in phases 5 and 7,
once the grouped server drains, before the checks' own launches), and
each kernel of the path must have launched there.  The last lines are a
JSON object with the SVDs', the solves', the servers' and phases 6, 7, 9,
8, 10, 11, 12, 13 and 14's numbers, the card's name and power limit, a JSON
object with each kernel's numbers, and {"ok": true, "device": {...}}.
Any failed check exits non-zero before those lines.
Exits non-zero at once when there is no CUDA device or when the port's
sources are not beside this script.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# The port's sources beside this script; without them the import below
# fails and the script exits non-zero before it prints anything.
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch import machine as _machine  # noqa: E402
M, N = 1 << 21, 1024           # A: rows x columns, the paper's tall-skinny
K_SVD = 16                     # singular triplets asked of the SVD
K_GEMM = 16                    # columns of B in the gemm check
M_W, N_W = 1 << 18, 16384      # A_w: the wide matrix of the randomized SVD
R_SKETCH = K_SVD + 10          # k + p, the randomized SVD's sketch width
K_MULTI = (1, 8, 16, 40)       # slot counts of the fused_grad_multi check
SLOTS = 8                      # the server's slots per group
M_S, N_S = 1 << 22, 1 << 14   # S: the sparse matrix of phase 6
BS_S, ELL_S = 32, 16           # S's block size and stored blocks a block-row
K_U = 16                       # bsr_matmul's nx (U recovery) in phase 2
SPARSE_ITERS = 300             # iterations of phase 6's quad solves
# Phase 6's quad solves: the float64 ||S^T(Sx - b)|| / ||S^T b|| after
# SPARSE_ITERS gra steps at L0 = sigma_1^2.  Gradient descent from 0 leaves
# (1 - lambda/L)^k of each mode; over S's block-column spectrum that is
# about 0.006 at 300 steps (tools/sparse_spectrum.py).
REL_GRAD_LIMIT = 2e-2
K_BSR_MULTI = (1, 8, 16, 40)   # slot counts of the fused_grad_bsr_multi check
M_SIM, N_SIM = 1 << 20, 1 << 12   # S_sim: the matrix of phase 7's DIMSUM
PLANTED = 64                   # planted near-duplicate column pairs of S_sim
SIM_THRESHOLD = 0.5            # phase 7's sampled DIMSUM request
# Phase 7's iteration caps, chosen to keep the phase near 40 s: quad/gra,
# quad/acc_rb and logistic/lbfgs requests on S.
SPARSE_SERVE_ITERS = {"gra": 60, "acc_rb": 40, "lbfgs": 20}
# Phase 7's served gra requests: the float64 relative gradient after their
# cap.  60 steps at 1/L0 leave 0.055 (tools/sparse_spectrum.py); the group
# backtracks, so its L stays within 2 L0, and 30 steps at 1/(2 L0) leave
# 0.093.
SERVE_REL_GRAD_LIMIT = 0.15
# Phase 8: greedy generation on two LM configurations at full width and
# depth (bf16 weights from a seed): B prompts of S tokens, G tokens each.
LM_MODELS = {"llama3.2-3b": "flash_attention",
             "falcon-mamba-7b": "selective_scan"}
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
LM_F32_LAYERS = 4              # depth of the f32 prefill-against-decode check
# Then the moe family (MLA attention, MoE FFN) at full width, each model's
# depth cut so that one card holds its bf16 weights: deepseek-v2-236b 1
# dense + 3 MoE layers (13.3 B parameters), deepseek-v3-671b 3 dense + 1
# MoE layer and its MTP block's weights (26.7 B).  flash_attention at head
# dim 192 (the materialized q·k width, 128 + 64 rotary), one a layer.
LM_MOE_LAYERS = {"deepseek-v2-236b": 4, "deepseek-v3-671b": 4}
# Prefill against decode of a MoE model holds only where no token-expert
# pair is dropped: prefill sizes capacity over B·S tokens, a decode step
# over B, so a pair dropped in one is kept in the other (the reference's
# semantics; random weights route unevenly, and at the configs' 1.25 a
# tenth to a fifth of the prefill's pairs are dropped).  The bf16 checks
# run at the capacity factor the reference's smoke_config sets for the
# same reason and require that nothing was dropped; the reading at 1.25
# is recorded beside them.  In bf16 the decoded token's hidden state parts
# from the same token's in the long prefill by about 1% (bf16 roundings
# in another order, in either decode mode), and a router gap between the
# k-th and (k+1)-th expert as small as 1e-5 then sends the token to
# another expert set (tools/diagnose_moe_pvd.py): a discrete choice, not
# rounding.  So bf16 holds TOL_LM on the rows whose last token was routed
# alike at every MoE layer (one at least) and records every row; f32
# holds every row.  Both decode modes, in both types.
PVD_CAPACITY_FACTOR = 8.0
# The f32 checks take one prompt of LM_F32_MOE_PROMPT + 1 tokens at a
# capacity of every token (capacity_factor E / top_k, rounded up), which
# no routing can overflow: within one prompt the load is more skewed than
# over four, and deepseek-v3-671b's 60 GB of f32 weights at 4 layers
# leave room for no larger dispatch buffer (256 experts x 1025 slots x
# 7168 f32, 7.5 GB).
LM_F32_MOE_PROMPT = 1024
# Plain attention over 512 heads at S = 2049 would hold 8.6 GB of f32
# scores (three times over) beside the weights: it runs this many heads a
# call.
PLAIN_HEADS = 64
# Last, the four registered dense/vlm configurations at full width, one
# generate each (None: full depth); llava-next-34b with its 2880 patch
# embeddings in a prompt of LM_VLM_PROMPT tokens.
LM_CONFIGS = {"qwen3-4b": None, "qwen2.5-32b": 4, "deepseek-coder-33b": 4,
              "llava-next-34b": 4}
LM_VLM_PROMPT = 4096
# Then the last two families at full width and full depth in bf16:
# zamba2-1.2b (hybrid) and seamless-m4t-large-v2 (encdec, its encoder on
# LM_PROMPT frames, the prompt's length, as serve_llm draws them); the
# launches each prefill makes are family_launches'.
LM_FAMILIES = ("zamba2-1.2b", "seamless-m4t-large-v2")
# Their f32 prefill-against-decode checks: zamba2 at one group of 6 and
# the tail of 2 (LM_F32_LAYERS = 4 would hold no group), seamless at full
# depth with LM_ENC_FRAMES frames against a prompt of LM_PROMPT + 1, the
# length its cross-attention check also takes.
LM_HYBRID_F32_LAYERS = 8
LM_ENC_FRAMES = 1500
# Phase 8's limits, normwise relative.  flash_attention in bf16: the kernel
# rounds the softmax weights to bf16 before the PV product (2^-9 each), as
# the reference kernel does, and the plain version does not.  Prefill
# against decode in bf16: the two paths round the residual stream to bf16
# (2^-8) at different places in each of 28 (64) layers.
# The reference's chunked SSD form of Mamba2 (timed beside the kernel)
# against the kernel: the same recurrence summed in chunks, 1e-3 as in
# the CPU tests (tests/test_torch_mamba2.py).
TOL_LM = {"flash_f32": 1e-4, "flash_bf16": 1e-2, "scan": 1e-4,
          "pvd_f32": 1e-4, "pvd_bf16": 5e-2, "ssd": 1e-3}
# Phase 9: the paper's front doors.  (a) the four Figure-1 problems at
# make_problem's sizes through every method (the default caps), each final
# objective within FIG1_CPU_TOL of the same call on the CPU, relative; a
# backtracking method's history ends within FIG1_DESCENT of its lowest
# value.  One pair is held otherwise: `logistic` is separable (its infimum
# 0 is not attained), and lbfgs runs on toward it until its own test stops
# it at about 6e-12 on both devices (on an H100: 3.7e-3 apart relative,
# 2.3e-14 absolute), where a relative comparison reads only the point each
# run stopped at.  When both runs of that pair converged, the two
# objectives are held to FIG1_FLOOR_ULPS f32 ulps of the first iterate's
# objective (3.65e-3, so 1.7e-9): the two runs agree to the rounding of
# the objective's scale.
FIG1_NAMES = ("linear", "linear_l1", "logistic", "logistic_l2")
FIG1_BACKTRACKING = ("acc_b", "acc_rb", "lbfgs")
FIG1_CPU_TOL = 1e-5
FIG1_AT_INFIMUM = ("logistic", "lbfgs")
FIG1_FLOOR_ULPS = 4
F32_EPS = float(torch.finfo(torch.float32).eps)
FIG1_DESCENT = 1e-5
# (b) `linear` at M_LIN rows (4 GiB f32) and (c) the lasso on its A: stops
# that f32 reaches within minimize's default cap of LIN_ITERS.  gra and
# acc_rb stop at a relative step below 1e-6; lbfgs at ||g|| below tol |f|,
# and x rounded to f32 alone leaves ||g|| = ||A^T A dx|| near
# m * 4e-7 against f* near 0.005 m (noise 0.1), a ratio of 8e-5, so its
# tol is 1e-3 (||x - x*|| near 5e-6, f - f* near 1e-9 f*).
M_LIN = 1 << 20
LIN_ITERS = 200
LIN_TOL = {"gra": 1e-6, "acc_rb": 1e-6, "lbfgs": 1e-3}
LASSO_PLANTED, LASSO_LAM = 10, 1.0
# (d) the smoothed LP: M_LP constraints, N_LP variables, dense.
M_LP, N_LP = 1 << 12, 1 << 14
# Continuations and iterations chosen on an H100 (700 W): at
# (10, 800) max |x - x*| was 0.076 and feasibility 1.3e-2, at (20, 1000)
# 0.033 and 8.4e-3, at (40, 1000) 0.014 and 3.6e-3 in 3.4 s.
LP_CONTINUATIONS, LP_ITERS = 40, 1000
# (e) the CoordinateMatrix: 2^27 entries filling 32 x 32 blocks.
M_C, N_C = 1 << 18, 1 << 14
COO_RESTARTS = 100             # Lanczos restart cap of phase 9's SVDs
N_BLOCK = 8192                 # (f) BlockMatrix.multiply, square
SERVE_ARGS = ["--m", "1048576", "--n", "1024", "--requests", "16"]
SEED = 0
REPS = 10                      # timed launches per kernel (median taken)
ROWS64 = 1 << 18               # row chunk of the float64 reference sums
ROWS64_W = 1 << 14             # the same for A_w (2 GB of float64 a chunk)
BROWS64_S = 8192               # block-rows of S a float64 chunk (1 GB)

# The bound's denominators: the NVIDIA H100 SXM data-sheet peaks, whose one
# home is the port's machine model (src/repro_torch/launch/machine.py).
HBM_BYTES_PER_S = _machine.HBM_BYTES_PER_S
PEAK_FLOPS = {torch.float32: _machine.F32_FMA_FLOPS,   # CUDA-core f32 FMA
              torch.bfloat16: _machine.BF16_FLOPS,     # tensor cores, dense
              torch.int8: _machine.INT8_FLOPS,         # tensor cores, dense
              torch.float8_e4m3fn: _machine.FP8_FLOPS,  # tensor cores, dense
              # TF32 tensor cores, dense: tsgram's route for f32, three
              # TF32 products (3xTF32) for each product, so its bound is
              # 3x its flops at this rate (the f32 CUDA-core figure is
              # printed beside it).
              "tf32": _machine.TF32_FLOPS}
EXP_PER_S = _machine.EXP_PER_S            # the special-function units

# Normwise relative tolerances, kernel against plain: g and the Gram sum
# over 2^21 rows in another order than cuBLAS does.
TOL = {"f": 1e-4, "z": 1e-4, "g": 5e-4, "tsgram": 5e-4, "gemm": 1e-4,
       "sketch": 1e-4, "bsr_matvec": 1e-4, "bsr_matmul": 1e-4,
       "bsr_rmatmul": 5e-4}
SOURCES = {
    # fused_grad is fused_grad_multi.cu's one-slot launch.
    "fused_grad": ("src/repro_torch/kernels/csrc/fused_grad_multi.cu",
                   "src/repro/kernels/fusedgrad.py:130"),
    "tsgram": ("src/repro_torch/kernels/csrc/tsgram.cu",
               "src/repro/kernels/tsgram.py:44"),
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:53"),
    "fused_grad_multi": ("src/repro_torch/kernels/csrc/fused_grad_multi.cu",
                         "src/repro/kernels/fusedgrad.py:320"),
    "randsketch": ("src/repro_torch/kernels/csrc/randsketch.cu",
                   "src/repro/kernels/randsketch.py:58"),
    "bsr_matvec": ("src/repro_torch/kernels/csrc/bsr_spmv.cu",
                   "src/repro/kernels/bsr.py:251"),
    "bsr_matmul": ("src/repro_torch/kernels/csrc/bsr_spmm.cu",
                   "src/repro/kernels/bsr.py:188"),
    "bsr_rmatmul": ("src/repro_torch/kernels/csrc/bsr_rmatmul.cu",
                    "src/repro/kernels/bsr.py:335"),
    # fused_grad_bsr is fused_grad_bsr_multi.cu's one-slot launch.
    "fused_grad_bsr": ("src/repro_torch/kernels/csrc/fused_grad_bsr_multi.cu",
                       "src/repro/kernels/fusedgrad.py:238"),
    "fused_grad_bsr_multi": (
        "src/repro_torch/kernels/csrc/fused_grad_bsr_multi.cu",
        "src/repro/kernels/fusedgrad.py:434"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:79"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:58"),
}
# The kernels each main path runs: phases 3-4 (solves and the Gram SVD),
# phase 5 (the server with its randomized-SVD one-shot), phase 6 (the
# sparse solves and the Lanczos SVD), phase 7 (the server on a sparse
# matrix, with DIMSUM requests on both matrix types) and phase 8 (LM
# serving; run_lm checks its own counts).
PATHS = {"solve_svd": ("fused_grad", "tsgram", "gemm"),
         "serve": ("fused_grad_multi", "randsketch", "gemm"),
         "sparse": ("bsr_matvec", "bsr_rmatmul", "bsr_matmul",
                    "fused_grad_bsr"),
         "sparse_serve": ("fused_grad_bsr_multi", "bsr_rmatmul", "tsgram"),
         # Phase 9's paths: the Figure-1 problems, linear and the lasso at
         # 2^20 rows, the converted CoordinateMatrix's Lanczos SVD,
         # BlockMatrix.multiply, api.compute_svd in Gram mode, serve.main.
         "fd_figure1": ("fused_grad",), "fd_linear": ("fused_grad",),
         "fd_lasso": ("fused_grad",),
         "fd_coordinate": ("bsr_matvec", "bsr_rmatmul", "bsr_matmul"),
         "fd_block": ("gemm",), "fd_svd": ("tsgram", "gemm"),
         "fd_serve": ("fused_grad_multi",),
         # Phase 11: A's and S's rows over the ranks of a process group,
         # the served groups on both and the elastic acc group on A
         # (every rank's counts; run_phase11 checks them).
         "cluster": ("fused_grad", "tsgram", "gemm", "randsketch",
                     "fused_grad_bsr", "fused_grad_multi", "bsr_matvec",
                     "bsr_rmatmul", "fused_grad_bsr_multi"),
         # Phase 12: the elastic executor's one-slot groups and server on
         # A, and the two-rank re-meshes on A and S (run_phase12 sums the
         # parent's cases and rank 0's).
         "elastic": ("fused_grad_multi", "fused_grad_bsr_multi"),
         # Phase 13: fp8 A's Gram SVD, solves, server, sketch (gemm) and
         # project (randsketch), one path a type.
         "e4m3": ("fused_grad", "tsgram", "gemm", "fused_grad_multi",
                  "randsketch"),
         "e5m2": ("fused_grad", "tsgram", "gemm", "fused_grad_multi",
                  "randsketch"),
         # Phase 14: SUMMA's one gemm a rank on the (2, 2) mesh (every
         # rank's counts; the CoordinateMatrix's products launch none),
         # then on the survivors of a dropped row shard.
         "mesh": ("gemm",), "mesh_survivor": ("gemm",)}


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of `fn` over `reps` launches, after two warm
    runs; CUDA events around each launch."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def one_launch(kernel, call, what: str):
    """`call()`, which must launch `kernel` (a wrapper with a launch count)
    exactly once, whatever the slot count."""
    before = kernel.launches
    out = call()
    require(kernel.launches == before + 1, f"{what}: "
            f"{kernel.launches - before} launches of {kernel.__name__} in "
            "one call")
    return out


def ptxas_report(sources=("fused_grad_multi.cu", "fused_grad_bsr_multi.cu",
                          "flash_attention.cu", "randsketch.cu", "tsgram.cu",
                          "bsr_spmm.cu", "bsr_rmatmul.cu", "gemm.cu",
                          "selective_scan.cu")) -> list:
    """Registers and spill bytes of every kernel in `sources`, and whether
    ptxas serialized its wgmmas, from the ptxas report of the build
    (kernels/_build.py's build_log)."""
    from repro_torch.kernels import _build

    rows, section, name, spill = [], None, None, None
    serialized = set()
    for line in _build.build_log().read_text().splitlines():
        line = line.strip()
        if line.startswith("== "):
            section = line[3:]
        elif section not in sources:
            continue
        elif "wgmma.mma_async instructions are serialized" in line:
            serialized.add(line.split("'")[1])
        elif line.startswith("ptxas info") and "Compiling entry" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line:
            spill = [int(w) for w in line.replace(",", " ").split()
                     if w.isdigit()][1:3]
        elif line.startswith("ptxas info") and "Used" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            rows.append({"source": section, "kernel": name, "registers": regs,
                         "spill_store_bytes": spill[0] if spill else None,
                         "spill_load_bytes": spill[1] if spill else None})
            name, spill = None, None
    for r in rows:
        r["wgmma_serialized"] = r["kernel"] in serialized
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, dn in zip(rows, names):
                r["kernel"] = dn.replace("(anonymous namespace)::", "")
    except OSError:
        pass
    require(bool(rows), f"no ptxas report for {sources}")
    return rows


def card() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(f"[card] torch.cuda.get_device_name(0) = {name}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return {"name": name, "nvidia_smi": line}


# -- phase 2: each kernel against its plain version -------------------------

def targets(loss: str, z: torch.Tensor, gen) -> torch.Tensor:
    if loss == "logistic":
        return torch.where(z + torch.randn(z.shape, generator=gen,
                                           device=z.device) > 0, 1.0, -1.0)
    if loss == "poisson":
        return torch.poisson(torch.exp(0.3 * z), generator=gen)
    return z + 0.5 * torch.randn(z.shape, generator=gen, device=z.device)


def check_kernels(A: torch.Tensor, gen) -> dict:
    """Every kernel at the main path's shapes in f32 and bf16 storage;
    returns {kernel: {dtype name: numbers}}."""
    from repro_torch.kernels import fusedgrad, gemm, tsgram

    dev = A.device
    out = {"fused_grad": {}, "tsgram": {}, "gemm": {}}
    x = torch.randn(N, generator=gen, device=dev)
    w = torch.rand(M, generator=gen, device=dev)
    w[-(M // 64):] = 0.0           # the zero-weight tail of padding rows
    B = torch.randn(N, K_GEMM, generator=gen, device=dev)
    z0 = fusedgrad.fused_grad_plain(A, x, torch.zeros(M, device=dev),
                                    w, loss="quad")[2]
    tgt = {loss: targets(loss, z0, gen) for loss in fusedgrad.LOSSES}
    del z0
    for dt in ("f32", "bf16"):
        a = A if dt == "f32" else A.to(torch.bfloat16)
        isz = a.element_size()

        # fused_grad, each loss.
        for loss in fusedgrad.LOSSES:
            t = tgt[loss]
            got = fusedgrad.fused_grad(a, x, t, w, loss=loss, param=0.5)
            want = fusedgrad.fused_grad_plain(a, x, t, w, loss=loss,
                                              param=0.5)
            torch.cuda.synchronize()
            errs = {k: rel_err(g, p) for k, g, p in zip("fgz", got, want)}
            for k, e in errs.items():
                require(e <= TOL[k], f"fused_grad {dt} {loss}: {k} "
                        f"relative error {e:.3e} > {TOL[k]}")
            again = fusedgrad.fused_grad(a, x, t, w, loss=loss, param=0.5)
            require(torch.equal(got[1], again[1])
                    and torch.equal(got[0], again[0]),
                    f"fused_grad {dt} {loss}: two runs differ")
            rec = {"rel_err": errs,
                   "max_abs_err": max(max_abs(g, p)
                                      for g, p in zip(got, want))}
            if loss == "quad":
                rec["ms"] = time_ms(lambda: fusedgrad.fused_grad(
                    a, x, t, w, loss=loss))
                rec["plain_ms"] = time_ms(lambda: fusedgrad.fused_grad_plain(
                    a, x, t, w, loss=loss))
                rec["library_ms"] = None     # no one torch call fuses these
                rec["bound_ms"], rec["bound_by"] = bound(
                    M * N * isz + 4 * (N + 2 * M) + 4 * (M + N + 1),
                    4.0 * M * N, a.dtype)
            out["fused_grad"].setdefault(dt, {})[loss] = rec
            del got, want, again

        # tsgram, and in f32 on A's ragged view against its aligned copy.
        out["tsgram"][dt] = check_tsgram(a, dt)
        if dt == "f32":
            ragged = a.view(-1)[1:1 + M * (N - 1)].view(M, N - 1)
            require(ragged.data_ptr() % 16 != 0, "the ragged view is aligned")
            rec = check_tsgram(ragged, "f32 ragged view")
            require(torch.equal(tsgram.tsgram(ragged, out_dtype=torch.float32),
                                tsgram.tsgram(ragged.clone(),
                                              out_dtype=torch.float32)),
                    "tsgram: the ragged view and its aligned copy differ")
            out["tsgram"][dt]["ragged"] = rec
            del ragged
            torch.cuda.empty_cache()

        # gemm, the skinny product of U recovery.
        got = gemm.gemm(a, B, out_dtype=torch.float32)
        want = gemm.gemm_plain(a, B, torch.float32)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["gemm"], f"gemm {dt}: relative error {e:.3e}")
        require(torch.equal(got, gemm.gemm(a, B, out_dtype=torch.float32)),
                f"gemm {dt}: two runs differ")
        Bc = B.to(a.dtype)
        out["gemm"][dt] = {
            "rel_err": e, "max_abs_err": max_abs(got, want),
            "ms": time_ms(lambda: gemm.gemm(a, B, out_dtype=torch.float32)),
            "plain_ms": time_ms(lambda: gemm.gemm_plain(a, B,
                                                        torch.float32)),
            "library_ms": time_ms(lambda: torch.mm(a, Bc)),
            **gemm_bound(a, B)}
        del got, want, Bc
        if dt == "f32":
            # A's ragged view (N - 1 columns, one element into its
            # storage): every row starts at another offset from a 16-byte
            # boundary; bit for bit its aligned copy.
            ragged = a.view(-1)[1:1 + M * (N - 1)].view(M, N - 1)
            require(ragged.data_ptr() % 16 != 0, "the ragged view is aligned")
            got = gemm.gemm(ragged, B[:N - 1], out_dtype=torch.float32)
            require(rel_err(got, gemm.gemm_plain(ragged, B[:N - 1],
                                                 torch.float32))
                    <= TOL["gemm"], "gemm: the ragged view is off plain")
            require(torch.equal(got, gemm.gemm(ragged.clone(), B[:N - 1],
                                               out_dtype=torch.float32)),
                    "gemm: the ragged view and its aligned copy differ")
            out["gemm"][dt]["ragged_bits_equal"] = True
            del ragged, got
        del a
        torch.cuda.empty_cache()
    for name, by_dtype in out.items():
        for dt, rec in by_dtype.items():
            r = rec["quad"] if name == "fused_grad" else rec
            for key, r in ((dt, r), (dt + " ragged", r.get("ragged"))):
                if r is None:
                    continue
                print(f"[kernels] {name:10s} {key:11s} kernel {r['ms']:9.3f} "
                      f"ms | plain {r['plain_ms']:9.3f} ms | library "
                      + ("     n/a" if r["library_ms"] is None
                         else f"{r['library_ms']:9.3f} ms")
                      + f" | bound {r['bound_ms']:8.3f} ms ({r['bound_by']}), "
                      f"share {r['bound_ms'] / r['ms']:.3f}"
                      + (f"; f32 CUDA-core bound {r['bound_cuda_core_ms']:.3f} "
                         "ms" if "bound_cuda_core_ms" in r else ""))
    return out


def gemm_bound(a: torch.Tensor, b: torch.Tensor) -> dict:
    """gemm's bound: one read of A and B and one write of C (f32), or
    2 m K N flops a TF32 product on its route at 495 TFLOP/s (three
    products for f32 A, two for bf16 A against f32 B)."""
    (m, k), n = a.shape, b.shape[1]
    products = 3 if a.dtype == torch.float32 else 2
    ms, by = bound(m * k * a.element_size() + k * n * b.element_size()
                   + 4 * m * n, products * 2.0 * m * k * n, "tf32")
    return {"bound_ms": ms, "bound_by": by}


def check_gemm_wide(A_w: torch.Tensor, gen) -> dict:
    """gemm at its serving shapes against plain: Y = A_w Z (Z of
    R_SKETCH columns, the randomized SVD's) and TSQR's Q = Y R^-1 (rows of
    R_SKETCH f32); two runs the same bits; timed beside torch.mm."""
    from repro_torch.kernels import gemm

    dev = A_w.device
    z = torch.randn(N_W, R_SKETCH, generator=gen, device=dev) / math.sqrt(N_W)
    y = torch.randn(M_W, R_SKETCH, generator=gen, device=dev)
    r_inv = torch.randn(R_SKETCH, R_SKETCH, generator=gen,
                        device=dev).triu() / math.sqrt(R_SKETCH)
    out = {}
    for key, a, b in (("A_w", A_w, z), ("tsqr", y, r_inv)):
        got = gemm.gemm(a, b, out_dtype=torch.float32)
        want = gemm.gemm_plain(a, b, torch.float32)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["gemm"], f"gemm {key}: relative error {e:.3e}")
        require(torch.equal(got, gemm.gemm(a, b, out_dtype=torch.float32)),
                f"gemm {key}: two runs differ")
        rec = {"shape": [*a.shape, b.shape[1]], "rel_err": e,
               "max_abs_err": max_abs(got, want),
               "ms": time_ms(lambda: gemm.gemm(a, b,
                                               out_dtype=torch.float32)),
               "plain_ms": time_ms(lambda: gemm.gemm_plain(
                   a, b, torch.float32), reps=3),
               "library_ms": time_ms(lambda: torch.mm(a, b)),
               **gemm_bound(a, b)}
        out[key] = rec
        del got, want
        print(f"[kernels] gemm {key:5s} {rec['shape']} kernel "
              f"{rec['ms']:9.3f} ms | plain {rec['plain_ms']:9.3f} ms | "
              f"library {rec['library_ms']:9.3f} ms | bound "
              f"{rec['bound_ms']:8.3f} ms ({rec['bound_by']}), share "
              f"{rec['bound_ms'] / rec['ms']:.3f}")
    return out


def tsgram_bound(m: int, n: int, dtype) -> dict:
    """tsgram's bound: one read of A and one write of G, or m n (n + 1)
    flops at the card's rate for A's type (three TF32 products each for
    f32, one bf16 product for bf16, one e4m3 product for e4m3); beside it
    the bound of the route the kernel runs where that is slower (f32 FMA
    on the CUDA cores for f32, the 16-bit mma.sync for e4m3)."""
    isz = torch.empty(0, dtype=dtype).element_size()
    nbytes, flops = m * n * isz + n * n * 4, float(m) * n * (n + 1)
    if isz == 2:
        b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
        return {"bound_ms": b_ms, "bound_by": b_by}
    if isz == 1:
        b_ms, b_by = bound(nbytes, flops, torch.float8_e4m3fn)
        return {"bound_ms": b_ms, "bound_by": b_by,
                "bound_route_ms": bound(nbytes, flops, torch.bfloat16)[0]}
    b_ms, b_by = bound(nbytes, 3 * flops, "tf32")
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_cuda_core_ms": bound(nbytes, flops, torch.float32)[0]}


def check_tsgram(a: torch.Tensor, what: str, reps: int = REPS) -> dict:
    """tsgram on `a` against its plain version (TOL["tsgram"], symmetric,
    the same bits twice), timed beside plain, mm(a.T, a) and its bound."""
    from repro_torch.kernels import tsgram

    got = tsgram.tsgram(a, out_dtype=torch.float32)
    want = tsgram.tsgram_plain(a, torch.float32)
    torch.cuda.synchronize()
    e = rel_err(got, want)
    require(e <= TOL["tsgram"], f"tsgram {what}: relative error {e:.3e} > "
            f"{TOL['tsgram']}")
    require(torch.equal(got, got.T), f"tsgram {what}: not symmetric")
    require(torch.equal(got, tsgram.tsgram(a, out_dtype=torch.float32)),
            f"tsgram {what}: two runs differ")
    rec = {"shape": list(a.shape), "rel_err": e,
           "max_abs_err": max_abs(got, want)}
    del got, want
    rec.update({
        "ms": time_ms(lambda: tsgram.tsgram(a, out_dtype=torch.float32),
                      reps=reps),
        "plain_ms": time_ms(lambda: tsgram.tsgram_plain(a, torch.float32),
                            reps=reps),
        "library_ms": time_ms(lambda: torch.mm(a.T, a), reps=reps),
        **tsgram_bound(a.shape[0], a.shape[1], a.dtype)})
    return rec


def multi_bound(k: int, isz: int) -> tuple[float, str]:
    """fused_grad_multi's bound for k slots: A once, X, T, W and Z, G, f;
    or its 4 m n k flops at the card's rate for the operands: bf16 tensor
    cores for bf16 A, f32 FMA for f32 A, and for e4m3 A against f32 X two
    TF32 products (A exact in TF32, X split hi/lo: gemm_bound's
    pricing)."""
    nbytes, flops = M * N * isz + 4 * k * (2 * N + 3 * M + 1), 4.0 * M * N * k
    if isz == 1:
        return bound(nbytes, 2 * flops, "tf32")
    return bound(nbytes, flops,
                 torch.bfloat16 if isz == 2 else torch.float32)


def multi_route_ms(k: int) -> float:
    """fused_grad_multi's bound on e4m3 A on the route it runs: f32 FMA on
    the CUDA cores."""
    return bound(M * N + 4 * k * (2 * N + 3 * M + 1), 4.0 * M * N * k,
                 torch.float32)[0]


def check_fused_grad_multi(A: torch.Tensor, gen) -> dict:
    """fused_grad_multi against its plain version for k in K_MULTI, every
    loss, f32 and bf16 storage; slot 0's bits against changes to the other
    slots and against slot 0 served alone, and zero-weight slots' exact
    zeros.  Returns {dtype: {k: ...}}."""
    from repro_torch.kernels import fusedgrad

    dev = A.device
    out = {}
    for dt in ("f32", "bf16"):
        a = A if dt == "f32" else A.to(torch.bfloat16)
        for k in K_MULTI:
            x = torch.randn(k, N, generator=gen, device=dev)
            w = torch.rand(k, M, generator=gen, device=dev)
            w[:, -(M // 64):] = 0.0
            z0 = x @ A.T
            rec = {}
            for loss in fusedgrad.LOSSES:
                t = targets(loss, z0, gen)
                got = one_launch(
                    fusedgrad.fused_grad_multi,
                    lambda: fusedgrad.fused_grad_multi(
                        a, x, t, w, loss=loss, param=0.5),
                    f"fused_grad_multi {dt} k={k} {loss}")
                want = fusedgrad.fused_grad_multi_plain(a, x, t, w,
                                                        loss=loss, param=0.5)
                torch.cuda.synchronize()
                errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
                for q, e in errs.items():
                    require(e <= TOL[q], f"fused_grad_multi {dt} k={k} {loss}"
                            f": {q} relative error {e:.3e} > {TOL[q]}")
                again = fusedgrad.fused_grad_multi(a, x, t, w, loss=loss,
                                                   param=0.5)
                require(all(torch.equal(u, v) for u, v in zip(got, again)),
                        f"fused_grad_multi {dt} k={k} {loss}: two runs "
                        "differ")
                rec[loss] = {"rel_err": errs, "max_abs_err": max(
                    max_abs(g, p) for g, p in zip(got, want))}
                if k > 1 and loss in ("quad", "logistic"):
                    # Slot 0 keeps its bits whatever slots 1..k-1 hold;
                    # zero-weight slots give exactly zero f and g.
                    x2, t2, w2 = x.clone(), t.clone(), w.clone()
                    x2[1:] = torch.randn(k - 1, N, generator=gen, device=dev)
                    t2[1:] = targets(loss, x2[1:] @ A.T, gen)
                    w2[1:] = torch.rand(k - 1, M, generator=gen, device=dev)
                    w2[k // 2:] = 0.0
                    f2, g2, z2 = fusedgrad.fused_grad_multi(
                        a, x2, t2, w2, loss=loss, param=0.5)
                    torch.cuda.synchronize()
                    require(torch.equal(f2[0], got[0][0])
                            and torch.equal(g2[0], got[1][0])
                            and torch.equal(z2[0], got[2][0]),
                            f"fused_grad_multi {dt} k={k} {loss}: slot 0 "
                            "changed with the other slots")
                    require(bool((f2[k // 2:] == 0).all())
                            and bool((g2[k // 2:] == 0).all()),
                            f"fused_grad_multi {dt} k={k} {loss}: a "
                            "zero-weight slot is not exactly zero")
                    # ... and the same bits as slot 0 served alone.
                    f1, g1, z1 = fusedgrad.fused_grad_multi(
                        a, x[:1], t[:1], w[:1], loss=loss, param=0.5)
                    torch.cuda.synchronize()
                    require(torch.equal(f1[0], got[0][0])
                            and torch.equal(g1[0], got[1][0])
                            and torch.equal(z1[0], got[2][0]),
                            f"fused_grad_multi {dt} k={k} {loss}: slot 0 "
                            "differs from the same request served alone")
                    del x2, t2, w2, f2, g2, z2, f1, g1, z1
                if loss == "quad":
                    rec["ms"] = time_ms(lambda: fusedgrad.fused_grad_multi(
                        a, x, t, w, loss="quad"))
                    rec["plain_ms"] = time_ms(
                        lambda: fusedgrad.fused_grad_multi_plain(
                            a, x, t, w, loss="quad"))
                    rec["library_ms"] = None   # no one torch call fuses these
                    rec["bound_ms"], rec["bound_by"] = multi_bound(
                        k, a.element_size())
                del got, want, again, t
            out.setdefault(dt, {})[k] = rec
            del x, w, z0
        del a
        torch.cuda.empty_cache()
    for dt, by_k in out.items():
        for k, r in by_k.items():
            print(f"[kernels] fused_grad_multi k={k:2d} {dt:4s} kernel "
                  f"{r['ms']:9.3f} ms | plain {r['plain_ms']:9.3f} ms | "
                  f"library      n/a | bound {r['bound_ms']:8.3f} ms "
                  f"({r['bound_by']}), share {r['bound_ms'] / r['ms']:.3f}")
    return out


def check_randsketch(A_w: torch.Tensor, gen) -> dict:
    """randsketch against its plain version on A_w, r = R_SKETCH, f32 and
    bf16 storage, and on the ragged view of each (M_W x (N_W - 1), starting
    one element into the storage, so every row starts at another offset
    from a 16-byte boundary; no copy); returns {dtype: numbers}, the ragged
    view's under "ragged"."""
    from repro_torch.kernels import randsketch

    m, n = A_w.shape
    q = torch.randn(m, R_SKETCH, generator=gen, device=A_w.device)
    out = {}

    def measure(a, what):
        got = randsketch.randsketch(a, q, out_dtype=torch.float32)
        want = randsketch.randsketch_plain(a, q, torch.float32)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["sketch"], f"randsketch {what}: relative error "
                f"{e:.3e} > {TOL['sketch']}")
        require(torch.equal(got, randsketch.randsketch(
            a, q, out_dtype=torch.float32)), f"randsketch {what}: two runs "
            "differ")
        qc = q.to(a.dtype)
        rows, cols = a.shape
        b_ms, b_by = bound(rows * cols * a.element_size()
                           + 4 * R_SKETCH * (rows + cols),
                           2.0 * rows * cols * R_SKETCH, a.dtype)
        rec = {
            "shape": [rows, cols, R_SKETCH],
            "rel_err": e, "max_abs_err": max_abs(got, want),
            "ms": time_ms(lambda: randsketch.randsketch(
                a, q, out_dtype=torch.float32)),
            "plain_ms": time_ms(lambda: randsketch.randsketch_plain(
                a, q, torch.float32), reps=3),
            "library_ms": time_ms(lambda: torch.mm(a.T, qc)),
            "bound_ms": b_ms, "bound_by": b_by}
        return rec, got

    for dt in ("f32", "bf16"):
        a = A_w if dt == "f32" else A_w.to(torch.bfloat16)
        out[dt], whole = measure(a, dt)
        ragged = a.view(-1)[1:1 + m * (n - 1)].view(m, n - 1)
        require(ragged.data_ptr() % 16 != 0, "the ragged view is aligned")
        out[dt]["ragged"], got = measure(ragged, f"{dt} ragged view")
        # The ragged view's columns are A's shifted by one element along
        # its storage: not A's columns, so no bitwise check against
        # `whole`; its aligned copy gives the same bits.
        require(torch.equal(got, randsketch.randsketch(
            ragged.clone(), q, out_dtype=torch.float32)),
            f"randsketch {dt}: the ragged view and its aligned copy differ")
        del a, ragged, whole, got
        torch.cuda.empty_cache()
    for dt, rec in out.items():
        for r, view in ((rec, "A_w"), (rec["ragged"], "ragged")):
            print(f"[kernels] randsketch r={R_SKETCH} {dt:4s} {view:6s} "
                  f"kernel {r['ms']:9.3f} ms | plain {r['plain_ms']:9.3f} ms"
                  f" | library {r['library_ms']:9.3f} ms | bound "
                  f"{r['bound_ms']:8.3f} ms ({r['bound_by']}), share "
                  f"{r['bound_ms'] / r['ms']:.3f}")
    return out


def check_fused_grad_wide(A_w: torch.Tensor, gen) -> dict:
    """fused_grad (quad and logistic) against its plain version at A_w's
    width, where the row block is too wide to stage in shared memory, f32
    and bf16 storage; returns {dtype: numbers}."""
    from repro_torch.kernels import fusedgrad

    m, n = A_w.shape
    dev = A_w.device
    x = torch.randn(n, generator=gen, device=dev) / math.sqrt(n)
    w = torch.rand(m, generator=gen, device=dev)
    z0 = A_w @ x
    out = {}
    for dt in ("f32", "bf16"):
        a = A_w if dt == "f32" else A_w.to(torch.bfloat16)
        rec = {}
        for loss in ("quad", "logistic"):
            t = targets(loss, z0, gen)
            got = fusedgrad.fused_grad(a, x, t, w, loss=loss)
            want = fusedgrad.fused_grad_plain(a, x, t, w, loss=loss)
            torch.cuda.synchronize()
            errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
            for q, e in errs.items():
                require(e <= TOL[q], f"fused_grad {dt} {m} x {n} {loss}: {q}"
                        f" relative error {e:.3e} > {TOL[q]}")
            rec[loss] = {"rel_err": errs, "max_abs_err": max(
                max_abs(g, p) for g, p in zip(got, want))}
            if loss == "quad":
                rec["ms"] = time_ms(lambda: fusedgrad.fused_grad(
                    a, x, t, w, loss="quad"))
                rec["plain_ms"] = time_ms(lambda: fusedgrad.fused_grad_plain(
                    a, x, t, w, loss="quad"), reps=3)
                rec["bound_ms"], rec["bound_by"] = bound(
                    m * n * a.element_size() + 4 * (n + 2 * m)
                    + 4 * (m + n + 1), 4.0 * m * n, a.dtype)
            del got, want, t
        out[dt] = rec
        del a
        torch.cuda.empty_cache()
    for dt, r in out.items():
        print(f"[kernels] fused_grad {m} x {n} {dt:4s} kernel {r['ms']:9.3f} "
              f"ms | plain {r['plain_ms']:9.3f} ms | library      n/a | "
              f"bound {r['bound_ms']:8.3f} ms ({r['bound_by']}), share "
              f"{r['bound_ms'] / r['ms']:.3f}")
    return out


# -- float64 references for phases 3 and 4 ----------------------------------

def chunks(A: torch.Tensor, rows: int | None = None):
    rows = rows or ROWS64
    for i in range(0, A.shape[0], rows):
        yield i, A[i:i + rows].float().double()


def gram64(A: torch.Tensor) -> torch.Tensor:
    return sum(c.T @ c for _, c in chunks(A))


def quad_objective64(A, b, x) -> float:
    x = x.double()
    return 0.5 * sum(float(torch.sum((c @ x - b[i:i + ROWS64].double())
                                     ** 2)) for i, c in chunks(A))


def quad_optimum64(A, b, G) -> float:
    atb = sum(c.T @ b[i:i + ROWS64].double() for i, c in chunks(A))
    return quad_objective64(A, b, torch.linalg.solve(G, atb))


# -- phases 3 and 4: the main path -------------------------------------------

def run_svd(api, RowMatrix, A, G64) -> tuple[dict, float]:
    rm = RowMatrix.create(A, device=A.device)     # no copy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.svd(api.SvdRequest(A=rm, k=K_SVD, mode="gram",
                                 device=A.device))
    U, s, V = res.factors
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    w64 = torch.linalg.eigvalsh(G64).flip(0)[:K_SVD]
    s64 = torch.sqrt(w64.clamp_min(0))
    err_s = float(((s.double() - s64).abs() / s64).max())
    u = U.to_local().double()
    err_u = float(torch.linalg.matrix_norm(
        u.T @ u - torch.eye(K_SVD, dtype=torch.float64, device=A.device)))
    print(f"[svd] k={K_SVD}: {wall:.1f} ms, sigma_1 {float(s[0]):.6f}, "
          f"max relative error of sigma {err_s:.3e}, "
          f"||U^T U - I||_F {err_u:.3e}, a_passes {res.info['a_passes']}, "
          f"plan {res.info['plan']}")
    require(U.rows.shape == (M, K_SVD) and V.shape == (N, K_SVD),
            "svd: factor shapes")
    require(bool(torch.isfinite(s).all()), "svd: non-finite values")
    require(err_s <= 1e-4, f"svd: sigma relative error {err_s:.3e}")
    require(err_u <= 1e-3, f"svd: ||U^T U - I|| = {err_u:.3e}")
    require(res.info["a_passes"] == 2, "svd: a_passes != 2")
    require(res.info["plan"] == "gram", "svd: plan != gram")
    return {"ms": wall, "sigma_rel_err": err_s, "orth_err": err_u,
            "a_passes": res.info["a_passes"], "sigma": s.tolist()}, \
        float(s[0]) ** 2


def run_solve(api, ops, rm, b, **kw) -> tuple[dict, object]:
    before = ops.launch_counts()["fused_grad"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(api.SolveRequest(A=rm, b=b, precision="f32",
                                     device=rm.device, **kw), fused=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    info = res.info
    k, bt = info["iterations"], info["n_backtracks"]
    seed_passes = {"fused": 1, "fused_affine": 2}[info["plan"]]
    launched = ops.launch_counts()["fused_grad"] - before
    require(info["a_passes"] == seed_passes + k + bt,
            f"solve {kw}: a_passes {info['a_passes']} != formula")
    require(info["a_passes"] == launched,
            f"solve {kw}: a_passes {info['a_passes']} != {launched} "
            "fused_grad launches")
    require(bool(torch.isfinite(res.x).all()), f"solve {kw}: non-finite x")
    rec = {"loss": kw["loss"], "method": kw["method"], "plan": info["plan"],
           "iterations": k, "a_passes": info["a_passes"],
           "ms": wall, "ms_per_iteration": wall / max(k, 1)}
    return rec, res


# -- phase 5: the server ----------------------------------------------------

def wide_matrix(dev, gen) -> torch.Tensor:
    """A_w (M_W x N_W) with a decaying spectrum: a seeded rank-64 factor
    times a geometric decay, sigma_i ~ 100 * 0.8^i, plus small Gaussian
    noise (a flat spectrum would defeat two power iterations)."""
    rank = 64
    left = torch.randn(M_W, rank, generator=gen, device=dev) / math.sqrt(M_W)
    right = torch.randn(N_W, rank, generator=gen, device=dev) / math.sqrt(N_W)
    decay = 100.0 * 0.8 ** torch.arange(rank, device=dev, dtype=torch.float32)
    A_w = (left * decay) @ right.T
    for i in range(0, M_W, ROWS64_W):
        A_w[i:i + ROWS64_W].add_(torch.randn(
            min(ROWS64_W, M_W - i), N_W, generator=gen, device=dev),
            alpha=1e-4)
    return A_w


def sigma64(A_w: torch.Tensor, k: int, gen, block: int = 64,
            iters: int = 6) -> torch.Tensor:
    """The top-k singular values of A_w in float64 by plain block subspace
    iteration (independent of the port's randomized SVD): V spans the top
    right singular subspace after `iters` sweeps; sigma(A_w V) then."""
    n = A_w.shape[1]
    f64 = dict(dtype=torch.float64, device=A_w.device)
    V = torch.linalg.qr(torch.randn(n, block, generator=gen, **f64))[0]
    for _ in range(iters):
        Y = torch.cat([c @ V for _, c in chunks(A_w, ROWS64_W)])
        Q = torch.linalg.qr(Y)[0]
        Z = sum(c.T @ Q[i:i + ROWS64_W] for i, c in chunks(A_w, ROWS64_W))
        V = torch.linalg.qr(Z)[0]
    Y = torch.cat([c @ V for _, c in chunks(A_w, ROWS64_W)])
    return torch.linalg.svdvals(Y)[:k]


def serve_requests(api, rm, B_quad, B_log, L0, which) -> list:
    """The phase's solve requests, in submit order: 16 quad/gra, 8
    quad/acc_rb and 8 logistic/lbfgs; `which` picks rows of each block."""
    dev = rm.device
    spec = [("gra", "quad", 200, range(16)),
            ("acc_rb", "quad", 100, range(16, 24)),
            ("lbfgs", "logistic", 30, range(8))]
    reqs = []
    for method, loss, iters, rows in spec:
        for j in (r for i, r in enumerate(rows) if which(i)):
            b = B_quad[j] if loss == "quad" else B_log[j]
            reqs.append(api.SolveRequest(
                A=rm, b=b, loss=loss, method=method, L0=L0, tol=1e-9,
                max_iters=iters, device=dev))
    return reqs


def drive(server) -> dict:
    """Step `server` until it drains, synchronizing after each step, and
    watch its runners from outside: for each served request, the runner's
    passes from just before its admission step to just after its
    retirement step; for each step, its wall time, and whether one group
    ran alone at full width with no admission or retirement."""
    admitted, observed, results, full = {}, {}, {}, []
    t_start = time.perf_counter()
    while server.busy():
        runners = list(server._runners.values())
        before = {id(r): r.a_passes for r in runners}
        widths = [int(r.active.sum()) for r in runners if r.busy()]
        t0 = time.perf_counter()
        done = server.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        for r in server._runners.values():
            for meta in r.meta:
                if meta is not None:
                    admitted.setdefault(meta["req"].request_id,
                                        (r, before.get(id(r), 0)))
            if widths == [SLOTS] and id(r) in before and not done \
                    and int(r.active.sum()) == SLOTS:
                full.append((dt, r.a_passes - before[id(r)]))
        for res in done:
            results[res.request_id] = res
            if res.request_id in admitted:
                runner, start = admitted[res.request_id]
                observed[res.request_id] = runner.a_passes - start
    return {"results": results, "observed": observed, "full": full,
            "wall_s": time.perf_counter() - t_start}


def run_serve(api, ops, A, A_w, L0, G64, single_ms, gen) -> dict:
    """Phase 5 on the main path's counts: the caller zeroes them just
    before; they are read just after the grouped server drains (returned
    as "launches"), before the slots=1 server and the checks run."""
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.launch import telemetry
    from repro_torch.launch.serve import SolverServer

    dev = A.device
    rm = RowMatrix.create(A, device=dev)                 # no copy
    rm_w = RowMatrix.create(A_w, device=dev)
    # Targets from seeded x* and noise: 24 quad rows, 8 logistic rows.
    X_true = torch.randn(32, N, generator=gen, device=dev,
                         dtype=torch.float64)
    Z = torch.cat([c @ X_true.T for _, c in chunks(A)]).T      # (32, M)
    B_quad = (Z[:24] + 0.05 * torch.randn(24, M, generator=gen, device=dev,
                                         dtype=torch.float64)).float()
    B_log = torch.where(Z[24:] + torch.randn(8, M, generator=gen, device=dev,
                                             dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    del Z
    # float64 optima: one pass for A^T B, phase 3's Gram for the solve.
    AtB = sum(c.T @ B_quad[:, i:i + ROWS64].double().T
              for i, c in chunks(A))                           # (N, 24)
    X_star = torch.linalg.solve(G64, AtB)
    f_star = 0.5 * ((B_quad.double() ** 2).sum(1) - (X_star * AtB).sum(0))

    grouped = SolverServer(slots=SLOTS, telemetry=telemetry.Recorder())
    reqs = serve_requests(api, rm, B_quad, B_log, L0, lambda i: True)
    ids = [grouped.submit(r) for r in reqs]
    svd_id = grouped.submit(api.SvdRequest(A=rm_w, k=K_SVD, mode="auto",
                                           device=dev))
    sim_id = grouped.submit(api.SimilarityRequest(A=rm, device=dev))
    run = drive(grouped)
    # The path's launches: the slots=1 server below is a check.
    launched_group = ops.launch_counts()
    serial = SolverServer(slots=1)
    sreqs = serve_requests(api, rm, B_quad, B_log, L0, lambda i: i < 2)
    sids = [serial.submit(r) for r in sreqs]
    srun = drive(serial)

    # -- checks ------------------------------------------------------------
    res = {rid: run["results"][rid] for rid in ids}
    require(len(run["results"]) == len(ids) + 2, "serve: not every request "
            "was answered")
    for rid, r in res.items():
        require(r.info["plan"] == "fused-group", f"serve {rid}: plan "
                f"{r.info['plan']}")
        require(bool(torch.isfinite(r.x).all()), f"serve {rid}: non-finite x")
        require(r.info["a_passes"] == run["observed"][rid],
                f"serve {rid}: a_passes {r.info['a_passes']} != the "
                f"{run['observed'][rid]} group passes while resident")
    gaps = []
    for j, rid in enumerate(ids[:24]):
        d = res[rid].x.double() - X_star[:, j]
        gaps.append(float(0.5 * d @ G64 @ d / f_star[j]))
    require(max(gaps) <= 1e-5, f"serve: quad objective gap {max(gaps):.3e}")
    f0 = M * math.log(2.0)                   # logistic objective at x = 0
    log_obj = [res[rid].info["objective"] for rid in ids[24:]]
    require(all(math.isfinite(o) and o < f0 for o in log_obj),
            f"serve: logistic/lbfgs objectives {log_obj} do not fall below "
            f"{f0:.6e}")
    # Group against serial: the first two requests of each group.
    firsts = [ids[0], ids[1], ids[16], ids[17], ids[24], ids[25]]
    agree = []
    for rid, sid in zip(firsts, sids):
        xs = srun["results"][sid].x
        agree.append(rel_err(res[rid].x, xs))
    require(max(agree) <= 1e-4, f"serve: group and serial x differ by "
            f"{max(agree):.3e}")
    svd = run["results"][svd_id]
    s64 = sigma64(A_w, K_SVD, gen)
    err_s = float(((svd.factors[1].double() - s64).abs() / s64).max())
    require(svd.info["plan"] == "randomized", f"serve: the SVD took "
            f"{svd.info['plan']}")
    require(err_s <= 1e-3, f"serve: randomized sigma error {err_s:.3e}")
    # The exact DIMSUM of A against the float64 cosines of phase 3's Gram.
    sim = run["results"][sim_id]
    d64 = torch.sqrt(torch.diagonal(G64))
    err_sim = max_abs(sim.factors[0], G64 / (d64[:, None] * d64[None, :]))
    require(sim.info["plan"] == "gram" and sim.info["a_passes"] == 1,
            f"serve: similarity info {sim.info['plan']}, "
            f"{sim.info['a_passes']} A-passes")
    require(sim.factors[0].shape == (N, N) and err_sim <= 1e-4,
            f"serve: exact similarities off the float64 cosines by "
            f"{err_sim:.3e}")
    launched = ops.launch_counts()
    a_passes = grouped.stats["a_passes"] + serial.stats["a_passes"]
    require(launched_group["fused_grad_multi"] == grouped.stats["a_passes"],
            f"serve: {launched_group['fused_grad_multi']} fused_grad_multi "
            f"launches != {grouped.stats['a_passes']} server A-passes")
    require(launched["fused_grad_multi"] == a_passes,
            "serve: fused_grad_multi launches != A-passes with the serial "
            "server")
    require(launched_group["fused_grad"] == 0, "serve: fused_grad launched "
            "inside group steps")
    require(launched_group["randsketch"] == svd.info["power_iters"] + 1,
            f"serve: {launched_group['randsketch']} randsketch launches for "
            f"power_iters={svd.info['power_iters']}")

    # -- numbers -------------------------------------------------------------
    lat = sorted(grouped.latencies())
    full_ms = statistics.median(dt for dt, _ in run["full"])
    per_pass = statistics.median(dt / p for dt, p in run["full"] if p)
    oneshot = [sp.dur_s for sp in grouped.tel.spans
               if sp.name == "serve.oneshot"]
    rec = {
        "requests": len(ids) + 2, "wall_s": run["wall_s"],
        "requests_per_s": (len(ids) + 2) / run["wall_s"],
        "p50_latency_s": lat[len(lat) // 2],
        "p99_latency_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "steps": grouped.stats["steps"], "a_passes": grouped.stats["a_passes"],
        "serial_a_passes": serial.stats["a_passes"],
        "ms_per_group_iteration_8": full_ms,
        "ms_per_group_pass_8": per_pass,
        "single_fused_grad_ms_x8": 8 * single_ms,
        "max_quad_gap": max(gaps), "max_group_serial_rel": max(agree),
        "logistic_objectives": log_obj,
        "svd": {"plan": svd.info["plan"], "a_passes": svd.info["a_passes"],
                "tail_ratio": svd.info["tail_ratio"],
                "sigma_rel_err": err_s, "served_ms": 1e3 * oneshot[0]},
        "similarity": {"plan": sim.info["plan"], "max_abs_err": err_sim},
        "launches": launched_group}
    print(f"[serve] {rec['requests']} requests in {run['wall_s']:.2f} s "
          f"({rec['requests_per_s']:.2f} req/s), latency p50 "
          f"{rec['p50_latency_s']:.3f} s, p99 {rec['p99_latency_s']:.3f} s, "
          f"{rec['steps']} steps, {rec['a_passes']} group A-passes")
    print(f"[serve] 8 active slots: {full_ms:.3f} ms per group iteration, "
          f"{per_pass:.3f} ms per group pass, against 8 x single-request "
          f"fused_grad {8 * single_ms:.3f} ms")
    print(f"[serve] quad gap max {max(gaps):.3e}, group vs serial "
          f"{max(agree):.3e}, logistic objectives {min(log_obj):.6e}.."
          f"{max(log_obj):.6e} (f(0) = {f0:.6e})")
    print(f"[serve] randomized SVD k={K_SVD} on {M_W} x {N_W}: "
          f"{rec['svd']['served_ms']:.1f} ms served, "
          f"{svd.info['a_passes']} A-passes, tail_ratio "
          f"{svd.info['tail_ratio']:.3e}, sigma error {err_s:.3e}")
    print(f"[serve] exact DIMSUM of A ({N} x {N}): max abs error "
          f"{err_sim:.3e} against the float64 cosines")
    return rec

# -- phase 6: the sparse path ----------------------------------------------

def sparse_matrix(dev):
    """S (M_S x N_S, BS_S x BS_S blocks, ELL_S a block-row), built on the
    card: each block-row's block columns drawn without replacement from a
    Zipf(1) law over the N_S / BS_S block columns (Gumbel top-k) and sorted,
    Gaussian block entries; seed SEED + 3."""
    from repro_torch.core.distmat import SparseRowMatrix

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    nbr = M_S // BS_S
    cols = sparse_columns(nbr, gen, dev)
    data = torch.randn((nbr, ELL_S, BS_S, BS_S), generator=gen, device=dev)
    return SparseRowMatrix(data, cols, dims=(M_S, N_S), nnz=data.numel())


def sparse_columns(nbr: int, gen, dev, nbc: int | None = None
                   ) -> torch.Tensor:
    """S's block pattern: for each of `nbr` block-rows, ELL_S block columns
    drawn without replacement from a Zipf(1) law over `nbc` (S's N_S / BS_S
    unless given; Gumbel top-k), sorted; int32 (nbr, ELL_S)."""
    nbc = nbc or N_S // BS_S
    logp = -torch.log(torch.arange(1, nbc + 1, device=dev,
                                   dtype=torch.float32))
    cols = torch.empty((nbr, ELL_S), dtype=torch.int32, device=dev)
    step = 1 << 14
    for i in range(0, nbr, step):
        u = torch.rand(min(step, nbr - i), nbc, generator=gen, device=dev)
        keys = logp - torch.log(-torch.log(u.clamp_min(1e-30)))
        top = keys.topk(ELL_S, dim=1).indices
        cols[i:i + step] = torch.sort(top, dim=1).values.to(torch.int32)
    return cols


def _chunks64(a):
    """(first block-row, float64 blocks, int64 cols) over chunks of a
    BlockELL's block-rows, int8 scales applied."""
    nbr = a.cols.shape[0]
    for i in range(0, nbr, BROWS64_S):
        d = a.data[i:i + BROWS64_S].double()
        if a.scales is not None:
            d = d * a.scales[i:i + BROWS64_S, :, None, None].double()
        yield i, d, a.cols[i:i + BROWS64_S].long()


def apply64(a, X: torch.Tensor) -> torch.Tensor:
    """A X in float64 for a BlockELL A and X (n, k)."""
    bs = a.bs
    Xb = X.double().reshape(a.shape[1] // bs, bs, -1)
    out = []
    for _, d, c in _chunks64(a):
        y = torch.zeros((d.shape[0], bs, Xb.shape[-1]), dtype=torch.float64,
                        device=X.device)
        for s in range(a.ell):
            y += d[:, s] @ Xb[c[:, s]]
        out.append(y.reshape(-1, Xb.shape[-1]))
    return torch.cat(out)


def rapply64(a, Y: torch.Tensor) -> torch.Tensor:
    """A^T Y in float64 for a BlockELL A and Y (m, k)."""
    bs = a.bs
    Yb = Y.double().reshape(-1, bs, Y.shape[-1])
    g = torch.zeros((a.shape[1] // bs, bs, Y.shape[-1]), dtype=torch.float64,
                    device=Y.device)
    for i, d, c in _chunks64(a):
        yc = Yb[i:i + d.shape[0]]
        for s in range(a.ell):
            g.index_add_(0, c[:, s], d[:, s].transpose(1, 2) @ yc)
    return g.reshape(a.shape[1], -1)


def bsr_library(a):
    """torch.sparse_bsr_tensor of a BlockELL whose slots are all stored
    blocks (S has no padding slots), for the library yardstick; None for
    int8 storage, which torch's BSR product does not take."""
    if a.scales is not None:
        return None
    nbr, ell = a.cols.shape
    crow = torch.arange(0, nbr * ell + 1, ell, device=a.data.device)
    return torch.sparse_bsr_tensor(crow, a.cols.reshape(-1).long(),
                                   a.data.reshape(-1, a.bs, a.bs),
                                   size=a.shape)


def bsr_library_t(a):
    """torch.sparse_bsr_tensor of Aᵀ for a BlockELL A (its blocks
    transposed and regrouped by block column, stored once), for the
    library yardstick of AᵀX: torch's BSR product takes no transposed
    (SparseBsc) operand on CUDA.  None for int8 storage."""
    if a.scales is not None:
        return None
    flat = a.cols.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    nbc = a.shape[1] // a.bs
    crow = torch.zeros(nbc + 1, dtype=torch.long, device=flat.device)
    crow[1:] = torch.cumsum(torch.bincount(flat, minlength=nbc), 0)
    vals = a.data.reshape(-1, a.bs, a.bs)[order].transpose(1, 2).contiguous()
    return torch.sparse_bsr_tensor(crow, order // a.ell, vals,
                                   size=(a.shape[1], a.shape[0]))


def library_time(fn) -> tuple[float | None, str | None]:
    """One PyTorch call's time as the yardstick, or why there is none."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return time_ms(fn), None


def sparse_bound(a, nx: int, extra_bytes: float, flops_per_elem: float):
    """The bound of one pass over a BlockELL's stored blocks: the blocks,
    scales and cols read once plus `extra_bytes`, or the operations."""
    elems = a.data.numel()
    nbytes = (elems * a.data.element_size() + 4 * a.cols.numel()
              + (0 if a.scales is None else 4 * a.scales.numel())
              + extra_bytes)
    return bound(nbytes, flops_per_elem * nx * elems, a.data.dtype)


def rmatmul_bound(a, nx: int) -> dict:
    """bsr_rmatmul's bound on its route: one read of the stored blocks,
    scales, cols, X and one write of Y, or 2 nx flops a stored element as
    TF32 products (three a product for f32 blocks, 3xTF32; two for bf16 and
    int8 blocks, exact in TF32); beside it, as fma_bound_ms, the bound of
    f32 FMA on the CUDA cores."""
    t_bytes = sparse_bound(a, nx, 4 * nx * (a.shape[0] + a.shape[1]), 0.0)[0]
    flops = 2.0 * nx * a.data.numel()
    products = 3 if a.data.dtype == torch.float32 else 2
    t_ops = bound(0, products * flops, "tf32")[0]
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    return {"bound_ms": b_ms, "bound_by": b_by,
            "fma_bound_ms": max(t_bytes, bound(0, flops, torch.float32)[0])}


def check_sparse_kernels(mats: dict, gen) -> dict:
    """bsr_matvec, bsr_matmul (nx = K_U), bsr_rmatmul (nx = 1 and K_U) and
    fused_grad_bsr (every loss) against their plain versions on S in f32,
    bf16 and int8 storage (fused_grad_bsr: f32 and bf16; ops composes
    bsr_matvec and bsr_rmatmul for int8); each timed beside its plain
    version, its bound and, where one exists, torch's BSR product.
    Returns {kernel: {storage: numbers}}."""
    from repro_torch.kernels import bsr, fusedgrad

    dev = mats["f32"].device
    m, n = M_S, N_S
    x = torch.randn(n, generator=gen, device=dev)
    X = torch.randn(n, K_U, generator=gen, device=dev)
    U1 = torch.randn(m, 1, generator=gen, device=dev)
    U = torch.randn(m, K_U, generator=gen, device=dev)
    xs = x / math.sqrt(ELL_S * BS_S)          # unit-scale z = S xs
    w = torch.rand(m, generator=gen, device=dev)
    z0 = bsr.bsr_matvec_plain(mats["f32"]._local(), xs)
    tgt = {loss: targets(loss, z0, gen) for loss in fusedgrad.LOSSES}
    del z0
    out = {k: {} for k in PATHS["sparse"]}
    for dt, srm in mats.items():
        a = srm._local()
        lib = bsr_library(a)
        lib_t = bsr_library_t(a)
        cases = (("bsr_matvec", bsr.bsr_matvec, bsr.bsr_matvec_plain, x, 1,
                  4 * (n + m), lambda: lib @ x[:, None]),
                 ("bsr_matmul", bsr.bsr_matmul, bsr.bsr_matmul_plain, X, K_U,
                  4 * K_U * (n + m), lambda: lib @ X),
                 ("bsr_rmatmul", bsr.bsr_rmatmul, bsr.bsr_rmatmul_plain, U1,
                  1, 4 * (n + m), lambda: lib_t @ U1.to(lib_t.dtype)),
                 ("bsr_rmatmul", bsr.bsr_rmatmul, bsr.bsr_rmatmul_plain, U,
                  K_U, 4 * K_U * (n + m), lambda: lib_t @ U.to(lib_t.dtype)))
        for name, kern, plain, arg, nx, extra, libcall in cases:
            got = kern(a, arg)
            want = plain(a, arg)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            require(e <= TOL[name], f"{name} {dt} nx={nx}: relative error "
                    f"{e:.3e} > {TOL[name]}")
            require(torch.equal(got, kern(a, arg)),
                    f"{name} {dt} nx={nx}: two runs differ")
            bnd = (rmatmul_bound(a, nx) if name == "bsr_rmatmul" else dict(
                zip(("bound_ms", "bound_by"),
                    sparse_bound(a, nx, extra, 2.0))))
            lib_ms, lib_note = ((None, "int8 blocks: torch's BSR product "
                                 "takes no int8") if lib is None
                                else library_time(libcall))
            rec = {"nx": nx, "rel_err": e, "max_abs_err": max_abs(got, want),
                   "ms": time_ms(lambda: kern(a, arg)),
                   "plain_ms": time_ms(lambda: plain(a, arg)),
                   "library_ms": lib_ms, "library_note": lib_note, **bnd}
            key = dt if name != "bsr_rmatmul" or nx == 1 else f"{dt}_nx{nx}"
            out[name][key] = rec
            del got, want
        # bsr_matmul's columns do not depend on nx: Y[:, :j] at nx = K_U is
        # X[:, :j] run alone, and stays when X's other columns change.
        Y = bsr.bsr_matmul(a, X)
        for j in (1, 8):
            require(torch.equal(bsr.bsr_matmul(a, X[:, :j].contiguous()),
                                Y[:, :j]), f"bsr_matmul {dt}: columns :{j} "
                    f"at nx = {j} differ from nx = {K_U}")
        X2 = X.clone()
        X2[:, 8:] = 1.0 - 7.0 * X[:, 8:]
        require(torch.equal(bsr.bsr_matmul(a, X2)[:, :8], Y[:, :8]),
                f"bsr_matmul {dt}: columns :8 move with columns 8:")
        out["bsr_matmul"][dt]["columns_independent_of_nx"] = [1, 8, K_U]
        del Y, X2
        # So do bsr_rmatmul's (mma computes an output from its own column).
        Y = bsr.bsr_rmatmul(a, U)
        for j in (1, 8):
            require(torch.equal(bsr.bsr_rmatmul(a, U[:, :j].contiguous()),
                                Y[:, :j]), f"bsr_rmatmul {dt}: columns :{j} "
                    f"at nx = {j} differ from nx = {K_U}")
        U2 = U.clone()
        U2[:, 8:] = 1.0 - 7.0 * U[:, 8:]
        require(torch.equal(bsr.bsr_rmatmul(a, U2)[:, :8], Y[:, :8]),
                f"bsr_rmatmul {dt}: columns :8 move with columns 8:")
        out["bsr_rmatmul"][f"{dt}_nx{K_U}"]["columns_independent_of_nx"] = \
            [1, 8, K_U]
        del Y, U2, lib_t
        if dt == "int8":
            continue
        recs = {}
        for loss in fusedgrad.LOSSES:
            t = tgt[loss]
            got = fusedgrad.fused_grad_bsr(a, xs, t, w, loss=loss, param=0.5)
            want = fusedgrad.fused_grad_bsr_plain(a, xs, t, w, loss=loss,
                                                  param=0.5)
            torch.cuda.synchronize()
            errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
            for q, e in errs.items():
                require(e <= TOL[q], f"fused_grad_bsr {dt} {loss}: {q} "
                        f"relative error {e:.3e} > {TOL[q]}")
            again = fusedgrad.fused_grad_bsr(a, xs, t, w, loss=loss,
                                             param=0.5)
            require(all(torch.equal(u, v) for u, v in zip(got, again)),
                    f"fused_grad_bsr {dt} {loss}: two runs differ")
            rec = {"rel_err": errs, "max_abs_err": max(
                max_abs(g, p) for g, p in zip(got, want))}
            if loss == "quad":
                rec["ms"] = time_ms(lambda: fusedgrad.fused_grad_bsr(
                    a, xs, t, w, loss="quad"))
                rec["plain_ms"] = time_ms(lambda: fusedgrad.fused_grad_bsr_plain(
                    a, xs, t, w, loss="quad"))
                rec["library_ms"] = None     # no one torch call fuses these
                rec["bound_ms"], rec["bound_by"] = sparse_bound(
                    a, 1, 4 * (2 * n + 3 * m + 1), 4.0)
            recs[loss] = rec
            del got, want, again
        out["fused_grad_bsr"][dt] = recs
        del lib
        torch.cuda.empty_cache()
    for name, by in out.items():
        for key, r in by.items():
            r = r.get("quad", r)
            lib = ("    none" if r["library_ms"] is None
                   else f"{r['library_ms']:9.3f} ms")
            print(f"[kernels] {name:14s} {key:9s} kernel {r['ms']:9.3f} ms | "
                  f"plain {r['plain_ms']:9.3f} ms | library {lib} | bound "
                  f"{r['bound_ms']:8.3f} ms ({r['bound_by']}), share "
                  f"{r['bound_ms'] / r['ms']:.3f}")
    return out


def check_sparse_multi(mats: dict, gen) -> dict:
    """fused_grad_bsr_multi against its plain version on S for k in
    K_BSR_MULTI, every loss, f32 and bf16 storage, and the int8 composition
    (bsr_matmul + bsr_rmatmul through ops) at k = SLOTS; a request's bits
    alone, in slot 0 among random neighbours and in slot SLOTS - 1, and
    two runs' bits.  Returns {storage: {k: numbers}}."""
    from repro_torch.kernels import bsr as _bsr
    from repro_torch.kernels import fusedgrad, ops

    dev = mats["f32"].device
    m, n = M_S, N_S
    plain = fusedgrad.fused_grad_bsr_multi_plain
    out = {}
    for dt in ("f32", "bf16", "int8"):
        a = mats[dt]._local()
        run = ops.fused_grad_bsr_multi if dt == "int8" \
            else fusedgrad.fused_grad_bsr_multi
        for k in (SLOTS,) if dt == "int8" else K_BSR_MULTI:
            x = torch.randn(k, n, generator=gen, device=dev) \
                / math.sqrt(ELL_S * BS_S)
            w = torch.rand(k, m, generator=gen, device=dev)
            z0 = plain(a, x, torch.zeros_like(w), w, loss="quad")[2]
            rec = {}
            for loss in fusedgrad.LOSSES:
                t = targets(loss, z0, gen)
                got = one_launch(
                    _bsr.bsr_rmatmul if dt == "int8"
                    else fusedgrad.fused_grad_bsr_multi,
                    lambda: run(a, x, t, w, loss=loss, param=0.5),
                    f"fused_grad_bsr_multi {dt} k={k} {loss}")
                want = plain(a, x, t, w, loss=loss, param=0.5)
                torch.cuda.synchronize()
                errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
                for q, e in errs.items():
                    require(e <= TOL[q], f"fused_grad_bsr_multi {dt} k={k} "
                            f"{loss}: {q} relative error {e:.3e} > {TOL[q]}")
                again = run(a, x, t, w, loss=loss, param=0.5)
                require(all(torch.equal(u, v) for u, v in zip(got, again)),
                        f"fused_grad_bsr_multi {dt} k={k} {loss}: two runs "
                        "differ")
                rec[loss] = {"rel_err": errs, "max_abs_err": max(
                    max_abs(g, p) for g, p in zip(got, want))}
                if k == SLOTS and loss == "logistic":
                    # Slot 0's request alone, and among random neighbours in
                    # slot 0 and in slot SLOTS - 1: the same bits.
                    alone = run(a, x[:1], t[:1], w[:1], loss=loss, param=0.5)
                    x2 = torch.randn(k, n, generator=gen, device=dev) \
                        / math.sqrt(ELL_S * BS_S)
                    t2 = targets(loss, z0, gen)
                    w2 = torch.rand(k, m, generator=gen, device=dev)
                    for slot in (0, k - 1):
                        x3, t3, w3 = x2.clone(), t2.clone(), w2.clone()
                        x3[slot], t3[slot], w3[slot] = x[0], t[0], w[0]
                        grp = run(a, x3, t3, w3, loss=loss, param=0.5)
                        torch.cuda.synchronize()
                        require(all(torch.equal(u[0], v[slot])
                                    for u, v in zip(alone, grp)),
                                f"fused_grad_bsr_multi {dt}: slot {slot} "
                                "differs from the same request alone")
                    del alone, x2, t2, w2, x3, t3, w3, grp
                if loss == "quad":
                    rec["ms"] = time_ms(lambda: run(a, x, t, w, loss="quad"))
                    rec["plain_ms"] = time_ms(lambda: plain(
                        a, x, t, w, loss="quad"))
                    rec["library_ms"] = None   # no one torch call fuses these
                    rec["bound_ms"], rec["bound_by"] = sparse_bound(
                        a, k, 4 * k * (2 * n + 3 * m + 1), 4.0)
                del got, want, again, t
            out.setdefault(dt, {})[k] = rec
            del x, w, z0
        torch.cuda.empty_cache()
    for dt, by_k in out.items():
        for k, r in by_k.items():
            print(f"[kernels] fused_grad_bsr_multi k={k:2d} {dt:4s} kernel "
                  f"{r['ms']:9.3f} ms | plain {r['plain_ms']:9.3f} ms | "
                  f"library     none | bound {r['bound_ms']:8.3f} ms "
                  f"({r['bound_by']}), share {r['bound_ms'] / r['ms']:.3f}"
                  + (" (int8: bsr_matmul + bsr_rmatmul)"
                     if dt == "int8" else ""))
    return out


def sparse_solve(api, ops, srm, b, **kw) -> tuple[dict, object, dict]:
    """One api.solve on a SparseRowMatrix; returns its record, the result
    and the launches it made, by kernel."""
    fused = kw.pop("fused")
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(api.SolveRequest(A=srm, b=b, precision="f32",
                                     device=srm.device, **kw), fused=fused)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    made = {k: after[k] - before[k] for k in PATHS["sparse"]}
    info = res.info
    require(bool(torch.isfinite(res.x).all()), f"sparse solve {kw}: "
            "non-finite x")
    rec = {"loss": kw["loss"], "method": kw["method"], "fused": fused,
           "storage": "int8" if srm.scales is not None else "f32",
           "plan": info["plan"], "iterations": info["iterations"],
           "a_passes": info["a_passes"], "launches": made, "ms": wall,
           "ms_per_iteration": wall / max(info["iterations"], 1)}
    return rec, res, made


def run_sparse(api, ops, S, S_i8, refs) -> dict:
    """Phase 6 on the main path's counts (the caller zeroes them just
    before and reads them just after): the Lanczos SVD of S, then quad/gra
    fused and unfused, logistic/gra and quad/gra on the int8 copy."""
    a, a_i8 = S._local(), S_i8._local()
    dev = S.device
    # -- the Lanczos SVD (mode auto) --
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.svd(api.SvdRequest(A=S, k=K_SVD, device=dev))
    torch.cuda.synchronize()
    svd_ms = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    made = {k: after[k] - before[k] for k in PATHS["sparse"]}
    U, s, V = res.factors
    info = res.info
    require(info["plan"] == "lanczos", f"sparse svd: plan {info['plan']}")
    require(U.to_local().shape == (M_S, K_SVD) and V.shape == (N_S, K_SVD),
            "sparse svd: factor shapes")
    require(bool(torch.isfinite(s).all()), "sparse svd: non-finite sigma")
    V64, s64 = V.double(), s.double()
    R = rapply64(a, apply64(a, V64)) - V64 * s64 ** 2
    resid = torch.linalg.vector_norm(R, dim=0) / s64[0] ** 2
    eye = torch.eye(K_SVD, dtype=torch.float64, device=dev)
    orth_v = float(torch.linalg.matrix_norm(V64.T @ V64 - eye))
    u = U.to_local().double()
    orth_u = float(torch.linalg.matrix_norm(u.T @ u - eye))
    op_calls = info["op_calls"]
    require(float(resid.max()) <= 1e-4, f"sparse svd: residual "
            f"{float(resid.max()):.3e} sigma_1^2 > 1e-4")
    require(orth_v <= 1e-3, f"sparse svd: ||V^T V - I|| = {orth_v:.3e}")
    require(orth_u <= 1e-3, f"sparse svd: ||U^T U - I|| = {orth_u:.3e}")
    require(info["a_passes"] == 2 * op_calls + 1,
            f"sparse svd: a_passes {info['a_passes']} != 2 x {op_calls} + 1")
    require(made == {"bsr_matvec": op_calls, "bsr_rmatmul": op_calls,
                     "bsr_matmul": 1, "fused_grad_bsr": 0},
            f"sparse svd: launches {made} for {op_calls} operator calls")
    svd_rec = {"ms": svd_ms, "restarts": info["restarts"],
               "op_calls": op_calls, "a_passes": info["a_passes"],
               "converged": info["converged"], "sigma_1": float(s[0]),
               "sigma_16": float(s[-1]),
               "max_residual_over_sigma1sq": float(resid.max()),
               "orth_v": orth_v, "orth_u": orth_u, "launches": made}
    print(f"[sparse] Lanczos SVD k={K_SVD} of {M_S} x {N_S} (bs {BS_S}, "
          f"ell {ELL_S}): {svd_ms:.1f} ms, {info['restarts']} restarts, "
          f"{op_calls} operator calls, {info['a_passes']} A-passes, "
          f"converged {info['converged']}, sigma_1 {float(s[0]):.4f}, "
          f"max residual {float(resid.max()):.3e} sigma_1^2, "
          f"||V^T V - I|| {orth_v:.3e}, ||U^T U - I|| {orth_u:.3e}")
    L0 = float(s[0]) ** 2

    # -- the solves --
    solves = []
    quad = dict(loss="quad", method="gra", L0=L0, tol=1e-12,
                max_iters=SPARSE_ITERS)
    for srm, bell, fused in ((S, a, True), (S, a, False),
                             (S_i8, a_i8, True)):
        rec, r, made = sparse_solve(api, ops, srm, refs["b_quad"],
                                    fused=fused, **quad)
        key = "f32" if bell is a else "int8"
        x64 = r.x.double()[:, None]
        resid64 = apply64(bell, x64)[:, 0] - refs["b_quad"].double()
        grad = rapply64(bell, resid64[:, None])[:, 0]
        rec["rel_grad"] = float(torch.linalg.vector_norm(grad)
                                / refs["atb"][key])
        rec["objective64"] = 0.5 * float(resid64 @ resid64)
        n_att = rec["a_passes"]
        if srm is S_i8:        # int8: bsr_matvec + bsr_rmatmul an attempt
            want = {"bsr_matvec": n_att, "bsr_rmatmul": n_att,
                    "bsr_matmul": 0, "fused_grad_bsr": 0}
        elif fused:
            want = {"bsr_matvec": 0, "bsr_rmatmul": 0, "bsr_matmul": 0,
                    "fused_grad_bsr": n_att}
        else:                  # cached: one apply to seed, then one each
            k = r.info["iterations"] + r.info["n_backtracks"]
            want = {"bsr_matvec": 1 + k, "bsr_rmatmul": k, "bsr_matmul": 0,
                    "fused_grad_bsr": 0}
            require(n_att == 1 + 2 * k, f"unfused sparse solve: a_passes "
                    f"{n_att} != 1 + 2 x {k}")
        require(rec["plan"] == ("fused" if fused else "cached"),
                f"sparse quad {key} fused={fused}: plan {rec['plan']}")
        require(made == want, f"sparse quad {key} fused={fused}: launches "
                f"{made} for {n_att} A-passes")
        require(rec["rel_grad"] <= REL_GRAD_LIMIT, f"sparse quad {key} "
                f"fused={fused}: relative gradient {rec['rel_grad']:.3e} > "
                f"{REL_GRAD_LIMIT}")
        solves.append(rec)
    fused_obj, unfused_obj = (solves[0]["objective64"],
                              solves[1]["objective64"])
    gap = abs(fused_obj - unfused_obj) / fused_obj
    require(gap <= 1e-5, f"sparse quad: fused and unfused objectives "
            f"differ by {gap:.3e}")
    rec, r, made = sparse_solve(api, ops, S, refs["b_log"], fused=True,
                                loss="logistic", method="gra", L0=0.25 * L0,
                                tol=1e-12, max_iters=30)
    hist = r.info["history"][:rec["iterations"]].tolist()
    rec["first_last_objective"] = [hist[0], hist[-1]]
    require(rec["plan"] == "fused", f"sparse logistic: plan {rec['plan']}")
    require(made["fused_grad_bsr"] == rec["a_passes"],
            f"sparse logistic: launches {made}")
    require(all(b <= a_ * (1 + 1e-6) for a_, b in zip(hist, hist[1:]))
            and hist[-1] < hist[0],
            "sparse logistic: the objective does not fall monotonically")
    solves.append(rec)
    for r_ in solves:
        print(f"[sparse] {r_['loss']}/{r_['method']} {r_['storage']} "
              f"fused={r_['fused']}: plan {r_['plan']}, {r_['iterations']} "
              f"iterations, {r_['a_passes']} A-passes, "
              f"{r_['ms_per_iteration']:.3f} ms/iteration"
              + (f", relative gradient {r_['rel_grad']:.3e}"
                 if "rel_grad" in r_ else
                 f", objective {r_['first_last_objective'][0]:.6e} -> "
                 f"{r_['first_last_objective'][1]:.6e}"))
    print(f"[sparse] fused vs unfused objective {gap:.3e}")
    return {"svd": svd_rec, "solves": solves, "fused_unfused_gap": gap}


# -- phase 7: the server on a sparse matrix --------------------------------

def similarity_matrix(dev):
    """S_sim (M_SIM x N_SIM, BS_S x BS_S blocks, ELL_S a block-row, block
    columns from a Zipf(1) law over its N_SIM / BS_S, Gaussian entries;
    seed SEED + 5) with PLANTED near-duplicate column pairs: in block column
    c = 2p, column u + 1 (u = 2 (p mod 16)) of every stored block becomes
    0.9 column u + sqrt(0.19) of its own noise, a cosine near 0.9.  Returns
    the matrix and the pairs (i, j) of global column ids."""
    from repro_torch.core.distmat import SparseRowMatrix

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    nbr = M_SIM // BS_S
    cols = sparse_columns(nbr, gen, dev, nbc=N_SIM // BS_S)
    data = torch.randn((nbr, ELL_S, BS_S, BS_S), generator=gen, device=dev)
    pairs = []
    for p in range(PLANTED):
        c, u = 2 * p, 2 * (p % 16)
        rows, slots = torch.nonzero(cols == c, as_tuple=True)
        blk = data[rows, slots]
        blk[:, :, u + 1] = 0.9 * blk[:, :, u] \
            + math.sqrt(0.19) * blk[:, :, u + 1]
        data[rows, slots] = blk
        pairs.append((c * BS_S + u, c * BS_S + u + 1))
    return (SparseRowMatrix(data, cols, dims=(M_SIM, N_SIM),
                            nnz=data.numel()), pairs)


def similarity_refs64(S_sim, pairs) -> dict:
    """float64 column norms of S_sim and, for each planted pair (i, j), its
    cosine and s2 = sum_k (a_ki a_kj)^2 / (|c_i|^2 |c_j|^2), the variance
    formula's Gram entry."""
    a = S_sim._local()
    sq = torch.zeros((N_SIM // BS_S, BS_S), dtype=torch.float64,
                     device=a.data.device)
    for _, d, c in _chunks64(a):
        sq.index_add_(0, c.reshape(-1), (d * d).sum(dim=2).reshape(-1, BS_S))
    norms = torch.sqrt(sq.reshape(-1))
    cos, s2 = [], []
    for i, j in pairs:
        rows, slots = torch.nonzero(a.cols == i // BS_S, as_tuple=True)
        blk = a.data[rows, slots].double()
        ai = blk[:, :, i % BS_S] / norms[i]
        aj = blk[:, :, j % BS_S] / norms[j]
        cos.append(float((ai * aj).sum()))
        s2.append(float((ai * ai * aj * aj).sum()))
    f64 = dict(dtype=torch.float64, device=a.data.device)
    return {"norms": norms, "cos": torch.tensor(cos, **f64),
            "s2": torch.tensor(s2, **f64)}


def cosines64(A_d: torch.Tensor) -> torch.Tensor:
    """The float64 cosines of a dense matrix's columns, its Gram summed a
    chunk of ROWS64_W rows at a time."""
    n = A_d.shape[1]
    G = torch.zeros((n, n), dtype=torch.float64, device=A_d.device)
    for i in range(0, A_d.shape[0], ROWS64_W):
        c = A_d[i:i + ROWS64_W].double()
        G += c.T @ c
    d = torch.sqrt(torch.diagonal(G))
    inv = torch.where(d > 0, 1.0 / d.clamp_min(1e-300), 0.0)
    return G * inv[:, None] * inv[None, :]


def sparse_serve_requests(api, S, B_quad, B_log, L0, which) -> list:
    """Phase 7's solve requests on S, in submit order: 16 quad/gra, 8
    quad/acc_rb and 8 logistic/lbfgs at SPARSE_SERVE_ITERS; `which(method,
    i)` picks the i-th of each block."""
    spec = [("gra", "quad", range(16)), ("acc_rb", "quad", range(16, 24)),
            ("lbfgs", "logistic", range(8))]
    reqs = []
    for method, loss, rows in spec:
        for j in (r for i, r in enumerate(rows) if which(method, i)):
            b = B_quad[j] if loss == "quad" else B_log[j]
            reqs.append(api.SolveRequest(
                A=S, b=b, loss=loss, method=method, L0=L0, tol=1e-12,
                max_iters=SPARSE_SERVE_ITERS[method], device=S.device))
    return reqs


def sparse_serve_targets(S, gen) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 7's targets on S from seeded x* and noise: 24 quad rows and 8
    logistic rows."""
    dev = S.device
    X_true = torch.randn(N_S, 32, generator=gen, device=dev,
                         dtype=torch.float64) / math.sqrt(ELL_S * BS_S)
    Z = apply64(S._local(), X_true).T                         # (32, M_S)
    B_quad = (Z[:24] + 0.5 * torch.randn(24, M_S, generator=gen, device=dev,
                                         dtype=torch.float64)).float()
    B_log = torch.where(Z[24:] + torch.randn(8, M_S, generator=gen,
                                             device=dev,
                                             dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    return B_quad, B_log


def serve_sparse(api, S, S_sim, dense_sim, B_quad, B_log, L0) -> dict:
    """Phase 7's path, on the main path's counts (the caller zeroes them
    just before and reads them just after): one SolverServer(slots=SLOTS)
    on S answers the solve requests, a sampled and an exact DIMSUM request
    on S_sim and an exact one on its densified RowMatrix."""
    from repro_torch.launch import telemetry
    from repro_torch.launch.serve import SolverServer

    dev = S.device
    grouped = SolverServer(slots=SLOTS, telemetry=telemetry.Recorder())
    reqs = sparse_serve_requests(api, S, B_quad, B_log, L0,
                                 lambda method, i: True)
    ids = [grouped.submit(r) for r in reqs]
    sim_ids = {
        "sampled": grouped.submit(api.SimilarityRequest(
            A=S_sim, threshold=SIM_THRESHOLD, device=dev)),
        "exact": grouped.submit(api.SimilarityRequest(A=S_sim, device=dev)),
        "dense": grouped.submit(api.SimilarityRequest(A=dense_sim,
                                                      device=dev))}
    run = drive(grouped)
    return {"server": grouped, "reqs": reqs, "ids": ids, "sim_ids": sim_ids,
            "run": run}


def objective64(a, loss: str, B: torch.Tensor, X: torch.Tensor,
                m: int) -> tuple[list, torch.Tensor]:
    """float64 objectives of the rows of X (k, n) against the rows of B
    (k, m_pad) over S's first m rows, and the residuals Z - B (quad)."""
    Z = apply64(a, X.double().T).T[:, :m]
    Bm = B[:, :m].double()
    if loss == "quad":
        R = Z - Bm
        return (0.5 * (R * R).sum(dim=1)).tolist(), R
    mz = -Bm * Z
    return torch.logaddexp(torch.zeros_like(mz), mz).sum(dim=1).tolist(), None


def check_sparse_serve(api, ops, served, S, B_quad, B_log, pairs, refs, L0,
                       single_ms) -> dict:
    """Phase 7's checks, after the path's counts were read: the solves held
    to float64 figures of their own x and to a slots=1 server and api.solve
    (whose launches count on no path); the DIMSUM answers held to float64
    cosines of S_sim over the whole matrix (exact) or on the planted pairs
    (sampled)."""
    from repro_torch.launch.serve import SolverServer

    dev = S.device
    a = S._local()
    grouped, reqs, ids, run = (served["server"], served["reqs"],
                               served["ids"], served["run"])
    before = ops.launch_counts()
    serial = SolverServer(slots=1)
    sreqs = sparse_serve_requests(api, S, B_quad, B_log, L0,
                                  lambda method, i: method == "gra" or i < 2)
    sids = [serial.submit(r) for r in sreqs]
    srun = drive(serial)
    made = ops.launch_counts()["fused_grad_bsr_multi"] \
        - before["fused_grad_bsr_multi"]
    require(made == serial.stats["a_passes"], f"sparse serve: the serial "
            f"server launched fused_grad_bsr_multi {made} times for "
            f"{serial.stats['a_passes']} A-passes")

    # -- the solves ----------------------------------------------------------
    res = {rid: run["results"][rid] for rid in ids}
    require(len(run["results"]) == len(ids) + len(served["sim_ids"]),
            "sparse serve: not every request was answered")
    for rid, r in res.items():
        require(r.info["plan"] == "fused-group", f"sparse serve {rid}: plan "
                f"{r.info['plan']}")
        require(bool(torch.isfinite(r.x).all()), f"sparse serve {rid}: "
                "non-finite x")
        require(r.info["a_passes"] == run["observed"][rid],
                f"sparse serve {rid}: a_passes {r.info['a_passes']} != the "
                f"{run['observed'][rid]} group passes while resident")
    # Each served objective against a float64 evaluation at its own x.
    Xq = torch.stack([res[rid].x for rid in ids[:24]])
    Xl = torch.stack([res[rid].x for rid in ids[24:]])
    quad64, R = objective64(a, "quad", B_quad, Xq, M_S)
    log64, _ = objective64(a, "logistic", B_log, Xl, M_S)
    quad_obj = [res[rid].info["objective"] for rid in ids[:24]]
    log_obj = [res[rid].info["objective"] for rid in ids[24:]]
    obj_rel = max(abs(o - o64) / abs(o64) for o, o64
                  in zip(quad_obj + log_obj, quad64 + log64))
    require(obj_rel <= TOL["f"], f"sparse serve: a served objective is "
            f"{obj_rel:.3e} off its float64 value at x")
    f0_quad = [0.5 * float((B_quad[j].double() ** 2).sum()) for j in range(24)]
    require(all(o < f for o, f in zip(quad64, f0_quad)),
            "sparse serve: a quad objective did not fall below f(0)")
    f0_log = M_S * math.log(2.0)
    require(all(math.isfinite(o) and o < f0_log for o in log64),
            f"sparse serve: logistic objectives {log64} not below "
            f"{f0_log:.6e}")
    # The gra requests: float64 ||S^T(Sx - b)|| / ||S^T b||.
    grad = torch.linalg.vector_norm(rapply64(a, R[:16].T), dim=0)
    atb = torch.linalg.vector_norm(rapply64(a, B_quad[:16].T), dim=0)
    rel_grad = (grad / atb).tolist()
    del R, grad
    require(max(rel_grad) <= SERVE_REL_GRAD_LIMIT, f"sparse serve: gra "
            f"relative gradient {max(rel_grad):.3e} > {SERVE_REL_GRAD_LIMIT}")
    # Group against serial: every gra request, two of acc_rb and lbfgs.
    firsts = ids[:16] + ids[16:18] + ids[24:26]
    agree = [rel_err(res[rid].x, srun["results"][sid].x)
             for rid, sid in zip(firsts, sids)]
    require(max(agree) <= 1e-4, f"sparse serve: group and serial x differ "
            f"by {max(agree):.3e}")
    # acc_rb against the direct path (api.solve takes the same engine; the
    # direct "gra" is the fixed-step method, the group's gra backtracks).
    direct = []
    for rid, req in zip(ids[16:24], reqs[16:24]):
        d = api.solve(api.SolveRequest(
            A=S, b=req.b, loss="quad", method="acc_rb", L0=L0, tol=1e-12,
            max_iters=SPARSE_SERVE_ITERS["acc_rb"], device=dev))
        direct.append(rel_err(res[rid].x, d.x))
    require(max(direct) <= 1e-4, f"sparse serve: group and direct acc_rb x "
            f"differ by {max(direct):.3e}")

    # -- DIMSUM ----------------------------------------------------------------
    sim = run["results"][served["sim_ids"]["sampled"]]
    info = sim.info
    S_est = sim.factors[0]
    pi = torch.tensor([i for i, _ in pairs], device=dev)
    pj = torch.tensor([j for _, j in pairs], device=dev)
    gamma64 = 10.0 * math.log(N_SIM) / SIM_THRESHOLD
    p64 = torch.clamp(math.sqrt(gamma64) / refs["norms"], max=1.0)
    var64 = refs["s2"] * (1.0 / (p64[pi] * p64[pj]) - 1.0)
    est = S_est[pi, pj].double()
    rel_pairs = (est - refs["cos"]).abs() / refs["cos"]
    gamma_rel = abs(info["gamma"] - gamma64) / gamma64
    p_rel = float(((info["p"].double() - p64).abs() / p64).max())
    var_rel = float(((info["variance"][pi, pj].double() - var64).abs()
                     / var64).max())
    require(info["plan"] == "dimsum" and info["a_passes"] == 1,
            f"sparse serve: DIMSUM info {info['plan']}, {info['a_passes']}")
    require(S_est.shape == (N_SIM, N_SIM)
            and bool(torch.isfinite(S_est).all()),
            "sparse serve: DIMSUM shape or non-finite entries")
    require(torch.equal(torch.diagonal(S_est), torch.ones(N_SIM, device=dev)),
            "sparse serve: DIMSUM diagonal is not exactly 1")
    require(gamma_rel <= 1e-6, f"sparse serve: gamma off by {gamma_rel:.3e}")
    require(p_rel <= 1e-6, f"sparse serve: p off by {p_rel:.3e}")
    require(var_rel <= 1e-3, f"sparse serve: variance off by {var_rel:.3e}")
    require(float(rel_pairs.mean()) < 0.15 and float(rel_pairs.max()) < 0.55,
            f"sparse serve: planted pairs' relative error mean "
            f"{float(rel_pairs.mean()):.3f}, max {float(rel_pairs.max()):.3f}")
    # The exact answers, sparse (strip-wise bsr_rmatmul Gram) and dense
    # (tsgram): normwise against the float64 cosines of the whole matrix
    # and against each other (phase 2's Gram limit), max-abs on the
    # diagonal and the planted pairs (the largest entries).
    exact = {}
    for key in ("exact", "dense"):
        r = run["results"][served["sim_ids"][key]]
        require(r.info["plan"] == "gram", f"sparse serve: {key} DIMSUM plan "
                f"{r.info['plan']}")
        exact[key] = r.factors[0]
    cos64 = refs["cos64"]
    exact_err = {}
    for key, C in exact.items():
        e = {"rel_err": rel_err(C, cos64), "max_abs_err": max_abs(C, cos64),
             "max_abs_err_pairs_diag": max(
                 max_abs(C[pi, pj], refs["cos"]),
                 max_abs(torch.diagonal(C), torch.diagonal(cos64)))}
        exact_err[key] = e
        require(e["rel_err"] <= TOL["tsgram"]
                and e["max_abs_err_pairs_diag"] <= 1e-4,
                f"sparse serve: {key} DIMSUM off the float64 cosines by "
                f"{e['rel_err']:.3e} normwise, "
                f"{e['max_abs_err_pairs_diag']:.3e} on the pairs and the "
                "diagonal")
    exact_err["sparse_vs_dense"] = {
        "rel_err": rel_err(exact["exact"], exact["dense"]),
        "max_abs_err": max_abs(exact["exact"], exact["dense"])}
    require(exact_err["sparse_vs_dense"]["rel_err"] <= TOL["tsgram"],
            f"sparse serve: sparse and dense exact DIMSUM differ by "
            f"{exact_err['sparse_vs_dense']['rel_err']:.3e} normwise")
    del exact

    # -- numbers -------------------------------------------------------------
    lat = sorted(grouped.latencies())
    full_ms = statistics.median(dt for dt, _ in run["full"])
    per_pass = statistics.median(dt / p for dt, p in run["full"] if p)
    n_req = len(run["results"])
    rec = {
        "requests": n_req, "wall_s": run["wall_s"],
        "requests_per_s": n_req / run["wall_s"],
        "p50_latency_s": lat[len(lat) // 2],
        "p99_latency_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "steps": grouped.stats["steps"], "a_passes": grouped.stats["a_passes"],
        "serial_a_passes": serial.stats["a_passes"],
        "iteration_caps": SPARSE_SERVE_ITERS,
        "ms_per_group_iteration_8": full_ms,
        "ms_per_group_pass_8": per_pass,
        "single_fused_grad_bsr_ms_x8": 8 * single_ms,
        "max_group_serial_rel": max(agree),
        "max_group_direct_acc_rb_rel": max(direct),
        "max_objective_rel_err": obj_rel, "gra_rel_grad": rel_grad,
        "quad_objectives": quad64, "logistic_objectives": log64,
        "dimsum": {"gamma": info["gamma"], "gamma_rel_err": gamma_rel,
                   "p_rel_err": p_rel, "variance_rel_err": var_rel,
                   "planted_rel_err_mean": float(rel_pairs.mean()),
                   "planted_rel_err_max": float(rel_pairs.max()),
                   "planted_cos64_mean": float(refs["cos"].mean())},
        "exact_dimsum": exact_err}
    print(f"[sparse serve] {n_req} requests in {run['wall_s']:.2f} s "
          f"({rec['requests_per_s']:.2f} req/s), latency p50 "
          f"{rec['p50_latency_s']:.3f} s, p99 {rec['p99_latency_s']:.3f} s, "
          f"{rec['steps']} steps, {rec['a_passes']} group A-passes, caps "
          f"{SPARSE_SERVE_ITERS}")
    print(f"[sparse serve] 8 active slots: {full_ms:.3f} ms per group "
          f"iteration, {per_pass:.3f} ms per group pass, against 8 x "
          f"single-request fused_grad_bsr {8 * single_ms:.3f} ms")
    print(f"[sparse serve] served objectives vs float64 {obj_rel:.3e}, gra "
          f"relative gradient max {max(rel_grad):.3e} (limit "
          f"{SERVE_REL_GRAD_LIMIT}), group vs serial {max(agree):.3e}, "
          f"group vs direct acc_rb {max(direct):.3e}")
    print(f"[sparse serve] DIMSUM on {M_SIM} x {N_SIM} (threshold "
          f"{SIM_THRESHOLD}, gamma {info['gamma']:.3f}): planted pairs' "
          f"relative error mean {float(rel_pairs.mean()):.4f}, max "
          f"{float(rel_pairs.max()):.4f} (cosine mean "
          f"{float(refs['cos'].mean()):.4f}); gamma {gamma_rel:.1e}, p "
          f"{p_rel:.1e}, variance {var_rel:.1e} off float64")
    print("[sparse serve] exact DIMSUM vs float64 cosines (normwise, max "
          "abs, max abs on the pairs and diagonal): " + "; ".join(
              f"{key} {e['rel_err']:.3e}, {e['max_abs_err']:.3e}, "
              f"{e['max_abs_err_pairs_diag']:.3e}"
              for key, e in exact_err.items() if key != "sparse_vs_dense")
          + f"; sparse vs dense "
          f"{exact_err['sparse_vs_dense']['rel_err']:.3e} normwise, "
          f"{exact_err['sparse_vs_dense']['max_abs_err']:.3e} max")
    return rec


def check_wide_kernels(S, S_sim, dense_sim) -> dict:
    """The kernels at the widths phase 7 gives them, against their plain
    versions: bsr_rmatmul on a 512-column strip of S_sim (each strip of its
    sparse Gram) and of S, and tsgram on S_sim's dense copy.  Returns
    {kernel: {case: numbers}}."""
    from repro_torch.kernels import bsr

    out = {"bsr_rmatmul": {}, "tsgram": {}}
    for key, srm in (("f32_nx512_S_sim", S_sim), ("f32_nx512_S", S)):
        a = srm._local()
        t0 = time.perf_counter()
        strip = srm._dense_columns(0, 512)
        torch.cuda.synchronize()
        densify_ms = (time.perf_counter() - t0) * 1e3
        got = bsr.bsr_rmatmul(a, strip)
        want = bsr.bsr_rmatmul_plain(a, strip)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["bsr_rmatmul"], f"bsr_rmatmul {key}: relative error "
                f"{e:.3e} > {TOL['bsr_rmatmul']}")
        require(torch.equal(got, bsr.bsr_rmatmul(a, strip)),
                f"bsr_rmatmul {key}: two runs differ")
        rec = {"nx": 512, "rel_err": e, "max_abs_err": max_abs(got, want),
               "ms": time_ms(lambda: bsr.bsr_rmatmul(a, strip), reps=3),
               "plain_ms": time_ms(lambda: bsr.bsr_rmatmul_plain(a, strip),
                                   reps=3),
               "densify_ms": densify_ms, **rmatmul_bound(a, 512),
               "strips": srm.shape[1] // 512}
        del got, want
        lib_t = bsr_library_t(a)
        rec["library_ms"] = time_ms(lambda: lib_t @ strip, reps=3)
        out["bsr_rmatmul"][key] = rec
        del strip, lib_t
    out["tsgram"]["f32_dense_sim"] = check_tsgram(
        dense_sim.rows, "on S_sim's dense copy", reps=3)
    for name, cases in out.items():
        for key, r in cases.items():
            lib = r.get("library_ms")
            print(f"[sparse serve] {name} {key}: rel err {r['rel_err']:.3e}, "
                  f"{r['ms']:.1f} ms (plain {r['plain_ms']:.1f} ms, "
                  + ("" if lib is None else f"library {lib:.1f} ms, ")
                  + f"bound {r['bound_ms']:.2f} ms by {r['bound_by']})")
    return out


# -- phase 9: the paper's front doors ----------------------------------------

def _descends(hist: list) -> bool:
    """A backtracking method's history: it ends below where it started and
    within FIG1_DESCENT of its lowest value (acceleration without restart
    is not monotone, and at f32's rounding floor values wiggle)."""
    low = min(hist)
    return hist[-1] < hist[0] and hist[-1] <= low + FIG1_DESCENT * abs(low)


def run_figure1(api, ops, dev) -> dict:
    """(a) api.minimize on the four make_problem problems at their default
    sizes through every method, fused="auto", the default caps; each
    against the same call on the CPU (the plain versions)."""
    from repro_torch.core import optim

    recs = []
    for name in FIG1_NAMES:
        p = optim.make_problem(name, device=dev)
        pc = optim.make_problem(name, device="cpu")
        f_star = None
        if name == "linear":
            rows = p.linop.A.rows
            f_star = quad_optimum64(rows, p.smooth.b, gram64(rows))
        for method in optim.METHODS:
            before = ops.launch_counts()["fused_grad"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = api.minimize(p, method)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = ops.launch_counts()["fused_grad"] - before
            xc, infoc = api.minimize(pc, method)
            f, fc = float(info["objective"]), float(infoc["objective"])
            k = info["iterations"]
            hist = info["history"][:k].tolist()
            rec = {"problem": name, "method": method, "plan": info["plan"],
                   "iterations": k, "a_passes": info["a_passes"],
                   "fused_grad_launches": launched,
                   "converged": bool(info["converged"]), "ms": ms,
                   "objective": f, "cpu_objective": fc,
                   "cpu_iterations": infoc["iterations"],
                   "rel_to_cpu": abs(f - fc) / max(abs(fc), 1e-300),
                   "cpu_converged": bool(infoc["converged"])}
            if f_star is not None:
                rec["gap64"] = (quad_objective64(p.linop.A.rows, p.smooth.b,
                                                 x) - f_star) / f_star
            recs.append(rec)
            print(f"[figure 1] {name}/{method}: plan {rec['plan']}, "
                  f"{k} iterations, {rec['a_passes']} A-passes, {launched} "
                  f"fused_grad launches, {ms:.1f} ms, objective {f:.8e} "
                  f"(CPU {fc:.8e}, relative {rec['rel_to_cpu']:.2e})"
                  + (f", gap to the float64 optimum {rec['gap64']:.3e}"
                     if "gap64" in rec else ""))
            require(bool(torch.isfinite(x).all()),
                    f"figure 1 {name}/{method}: non-finite x")
            at_floor = ((name, method) == FIG1_AT_INFIMUM
                        and rec["converged"] and rec["cpu_converged"]
                        and abs(f - fc) <= FIG1_FLOOR_ULPS * F32_EPS
                        * abs(hist[0]))
            rec["held_at_floor"] = at_floor
            require(rec["rel_to_cpu"] <= FIG1_CPU_TOL or at_floor,
                    f"figure 1 {name}/{method}: objective {f:.8e} against "
                    f"{fc:.8e} on the CPU")
            if info["plan"] in ("fused", "fused_affine"):
                require(info["a_passes"] == launched,
                        f"figure 1 {name}/{method}: {info['a_passes']} "
                        f"A-passes, {launched} fused_grad launches")
            else:
                require(launched == 0, f"figure 1 {name}/{method}: the "
                        f"{info['plan']} engine launched fused_grad")
            if method in FIG1_BACKTRACKING:
                require(_descends(hist), f"figure 1 {name}/{method}: the "
                        f"history does not descend ({hist[0]:.8e} -> "
                        f"{hist[-1]:.8e}, lowest {min(hist):.8e})")
        del p, pc
    torch.cuda.empty_cache()
    return {"runs": recs}


def run_linear_full(api, ops, dev) -> tuple[dict, object]:
    """(b) `linear` at M_LIN rows through gra, acc_rb and lbfgs to a stop
    before the cap; returns the record and the problem (its A serves
    (c))."""
    from repro_torch.core import optim
    from repro_torch.core.optim import problems

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = optim.make_problem("linear", m=M_LIN, device=dev)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    rows, b = p.linop.A.rows, p.smooth.b
    t0 = time.perf_counter()
    L = problems._lipschitz_sq_norm(rows)
    torch.cuda.synchronize()
    L_ms = (time.perf_counter() - t0) * 1e3
    require(abs(L - p.L) <= 1e-12 * p.L, f"linear: L {L} then {p.L}")
    G = gram64(rows)
    f_star = quad_optimum64(rows, b, G)
    s64 = torch.linalg.eigvalsh(G)
    L64 = float(s64[-1])
    del G
    # 50 power iterations, the reference's count, stop short of the top
    # of a spectrum this flat: L is recorded beside the Gram's, not held
    # to it.
    print(f"[linear] {M_LIN} x {N}: made in {make_s:.1f} s, on-device L "
          f"{L:.6e} in {L_ms:.1f} ms (float64 Gram's largest eigenvalue "
          f"{L64:.6e}), float64 optimum {f_star:.9e}")
    recs = []
    for method in ("gra", "acc_rb", "lbfgs"):
        before = ops.launch_counts()["fused_grad"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = api.minimize(p, method, max_iters=LIN_ITERS,
                               tol=LIN_TOL[method])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = ops.launch_counts()["fused_grad"] - before
        gap = (quad_objective64(rows, b, x) - f_star) / f_star
        rec = {"method": method, "tol": LIN_TOL[method],
               "plan": info["plan"], "iterations": info["iterations"],
               "a_passes": info["a_passes"], "fused_grad_launches": launched,
               "ms": ms, "ms_per_a_pass": ms / max(info["a_passes"], 1),
               "gap64": gap}
        recs.append(rec)
        print(f"[linear] {method}: plan {rec['plan']}, {rec['iterations']} "
              f"iterations, {rec['a_passes']} A-passes, {launched} "
              f"fused_grad launches, {ms:.1f} ms, gap to the float64 "
              f"optimum {gap:.3e}")
        require(info["iterations"] < LIN_ITERS,
                f"linear {method}: ran to its cap of {LIN_ITERS}")
        require(gap <= 1e-5, f"linear {method}: gap {gap:.3e}")
        require(info["a_passes"] == launched,
                f"linear {method}: {info['a_passes']} A-passes, {launched} "
                "fused_grad launches")
    return {"m": M_LIN, "n": N, "make_s": make_s, "L_ms": L_ms, "L": L,
            "L64": L64, "solves": recs}, p


def run_lasso(ops, rm, dev) -> dict:
    """(c) solve_lasso on `rm` (the M_LIN x N Gaussian A of (b)) with
    LASSO_PLANTED planted coefficients, as examples/lasso_tfocs.py plants
    them: b = A x_t + 0.05 noise, λ = 1."""
    from repro_torch.core.tfocs import solve_lasso

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x_t = torch.zeros(N, device=dev)
    x_t[:LASSO_PLANTED] = torch.randn(LASSO_PLANTED, generator=gen,
                                      device=dev) * 2
    b = rm.matvec(x_t) + 0.05 * torch.randn(rm.shape[0], generator=gen,
                                            device=dev)
    before = ops.launch_counts()["fused_grad"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solve_lasso(rm, b, LASSO_LAM)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = ops.launch_counts()["fused_grad"] - before
    f = float(info["objective"])
    f64, f_planted = (quad_objective64(rm.rows, b, v)
                      + LASSO_LAM * float(v.double().abs().sum())
                      for v in (x, x_t))
    support = int((x != 0).sum())
    rec = {"plan": info["plan"], "iterations": info["iterations"],
           "a_passes": info["a_passes"], "fused_grad_launches": launched,
           "n_backtracks": info["n_backtracks"],
           "n_restarts": info["n_restarts"], "ms": ms, "objective": f,
           "objective64": f64, "planted_objective64": f_planted,
           "support": support,
           "max_err_planted": float((x - x_t).abs().max())}
    print(f"[lasso] {rm.shape[0]} x {N}, {LASSO_PLANTED} planted, lambda "
          f"{LASSO_LAM}: plan {rec['plan']}, {rec['iterations']} iterations, "
          f"{rec['a_passes']} A-passes, {launched} fused_grad launches, "
          f"{ms:.1f} ms; objective {f:.9e} (float64 at x {f64:.9e}, at the "
          f"planted x {f_planted:.9e}), support {support}")
    require(info["iterations"] < 500, "lasso: ran to its cap of 500")
    require(abs(f - f64) <= 1e-5 * f64,
            f"lasso: objective {f:.9e} against float64 {f64:.9e}")
    require(f64 <= f_planted, f"lasso: objective {f64:.9e} above the planted "
            f"x's {f_planted:.9e}")
    require(info["a_passes"] == launched and info["plan"] == "fused_affine",
            f"lasso: plan {info['plan']}, {info['a_passes']} A-passes, "
            f"{launched} fused_grad launches")
    return rec


def run_lp(dev) -> dict:
    """(d) solve_smoothed_lp on a dense RowMatrix constraint matrix of
    M_LP x N_LP with a known optimum by strict complementarity, as
    tests/test_tfocs.py builds it (numpy, seed 7; M_LP / 2 active)."""
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.core.tfocs import (LinopMatrix, TfocsOptions,
                                        solve_smoothed_lp)

    rng = np.random.default_rng(7)
    k = M_LP // 2
    A = rng.normal(size=(M_LP, N_LP)).astype(np.float32)
    x_star = np.zeros(N_LP, np.float32)
    x_star[:k] = rng.random(k).astype(np.float32) + 0.5
    b = A @ x_star
    y = rng.normal(size=M_LP).astype(np.float32)
    s = np.zeros(N_LP, np.float32)
    s[k:] = rng.random(N_LP - k).astype(np.float32) + 0.1
    c = A.T @ y + s
    linop = LinopMatrix(RowMatrix.create(A, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, lam, info = solve_smoothed_lp(
        c, linop, b, mu=1e-2, continuations=LP_CONTINUATIONS,
        opts=TfocsOptions(max_iters=LP_ITERS, backtracking=True,
                          restart=True))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    kkt = info["kkt"]
    feas = kkt["primal_feasibility"] / float(np.linalg.norm(b))
    dx = float(np.abs(x.cpu().numpy() - x_star).max())
    its = [i["iterations"] for i in info["continuations"]]
    rec = {"m": M_LP, "n": N_LP, "continuations": LP_CONTINUATIONS,
           "max_iters": LP_ITERS, "iterations": its, "ms": ms,
           "primal_feasibility_rel": feas,
           "nonneg_violation": kkt["nonneg_violation"], "max_abs_dx": dx,
           "objective": kkt["objective"],
           "known_objective": float(c.astype(np.float64) @ x_star)}
    print(f"[lp] {M_LP} x {N_LP}, {LP_CONTINUATIONS} continuations of at "
          f"most {LP_ITERS}: iterations {its}, {ms:.1f} ms; primal "
          f"feasibility {feas:.3e} of ||b||, nonneg violation "
          f"{kkt['nonneg_violation']}, max |x - x*| {dx:.4f}, objective "
          f"{kkt['objective']:.6e} (known {rec['known_objective']:.6e})")
    require(kkt["nonneg_violation"] == 0.0, "lp: negative x")
    require(dx <= 0.05, f"lp: max |x - x*| = {dx:.4f} > 0.05")
    require(feas < 1e-2, f"lp: primal feasibility {feas:.3e} of ||b||")
    return rec


def coordinate_matrix(dev):
    """C (M_C x N_C) on `dev` (coordinate_entries) and its block count."""
    from repro_torch.core.distmat import CoordinateMatrix

    ri, ci, va, blocks = coordinate_entries(dev)
    return CoordinateMatrix.create(ri, ci, va, (M_C, N_C), device=dev), \
        blocks


def coordinate_entries(dev):
    """C's entries (rows, cols, values) on `dev` and its block count:
    every entry of BS_S x BS_S blocks, ELL_S a block-row, block columns
    from the Zipf(1) law of S's pattern (sparse_columns), Gaussian values;
    seed SEED + 11."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    nbr = M_C // BS_S
    cols = sparse_columns(nbr, gen, dev, nbc=N_C // BS_S).long()
    r = torch.arange(BS_S, device=dev)
    rows = (torch.arange(nbr, device=dev)[:, None, None, None] * BS_S
            + r[None, None, :, None]).expand(nbr, ELL_S, BS_S, BS_S)
    cs = (cols[:, :, None, None] * BS_S
          + r[None, None, None, :]).expand(nbr, ELL_S, BS_S, BS_S)
    ri = rows.reshape(-1).to(torch.int32)
    ci = cs.reshape(-1).to(torch.int32)
    del rows, cs
    va = torch.randn(ri.shape[0], generator=gen, device=dev)
    return ri, ci, va, nbr * ELL_S


def run_coordinate(api, ops, dev) -> dict:
    """(e) compute_svd(k=16, mode="lanczos") of C itself (segment-sum
    products) and of its to_sparse_row_matrix(bs=32) (bsr_matvec +
    bsr_rmatmul, bsr_matmul for U), on the path's counts."""
    t0 = time.perf_counter()
    C, blocks = coordinate_matrix(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    opts = {"max_restarts": COO_RESTARTS}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_c = api.svd(api.SvdRequest(A=C, k=K_SVD, mode="lanczos",
                                   options=opts, device=dev))
    torch.cuda.synchronize()
    coo_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    S_c = C.to_sparse_row_matrix(bs=BS_S)
    torch.cuda.synchronize()
    conv_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res_s = api.svd(api.SvdRequest(A=S_c, k=K_SVD, mode="lanczos",
                                   options=opts, device=dev))
    torch.cuda.synchronize()
    bsr_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    # ------------------------------------------------------------------
    a = S_c._local()
    stored = int((S_c.data != 0).flatten(2).any(-1).sum())
    out = {"m": M_C, "n": N_C, "nnz": C.nnz, "build_s": build_s,
           "convert_ms": conv_ms, "blocks": stored, "ell": S_c.ell,
           "launches": launches}
    s_ref = None
    for key, res, ms in (("coordinate", res_c, coo_ms),
                         ("sparse_row", res_s, bsr_ms)):
        U, s, V = res.factors
        V64, s64 = V.double(), s.double()
        R = rapply64(a, apply64(a, V64)) - V64 * s64 ** 2
        resid = float((torch.linalg.vector_norm(R, dim=0)
                       / s64[0] ** 2).max())
        info = res.info
        out[key] = {"ms": ms, "restarts": info["restarts"],
                    "op_calls": info["op_calls"],
                    "a_passes": info["a_passes"],
                    "converged": info["converged"], "sigma_1": float(s[0]),
                    "sigma_16": float(s[-1]), "sigma": s.tolist(),
                    "max_residual_over_sigma1sq": resid,
                    "has_u": U is not None}
        print(f"[coordinate] Lanczos SVD k={K_SVD} of {key}: {ms:.1f} ms, "
              f"{info['restarts']} restarts, {info['op_calls']} operator "
              f"calls, converged {info['converged']}, sigma_1 "
              f"{float(s[0]):.4f}, max residual {resid:.3e} sigma_1^2")
        require(resid <= 1e-4, f"coordinate {key}: residual {resid:.3e}")
        if s_ref is None:
            s_ref = s
    rel = float(((res_s.factors[1].double() - s_ref.double()).abs()
                 / s_ref.double()).max())
    out["sigma_rel_diff"] = rel
    op_calls = res_s.info["op_calls"]
    print(f"[coordinate] {M_C} x {N_C}, {C.nnz} entries built in "
          f"{build_s:.1f} s, converted to bs {BS_S} in {conv_ms:.1f} ms "
          f"({stored} blocks, ell {S_c.ell}); sigma of the two runs apart "
          f"by {rel:.3e}; launches {launches}")
    require(rel <= 1e-4, f"coordinate: sigma apart by {rel:.3e}")
    require(stored == blocks and S_c.ell == ELL_S,
            f"coordinate: {stored} blocks (ell {S_c.ell}), {blocks} distinct")
    require(res_c.factors[0] is None and res_s.factors[0] is not None,
            "coordinate: U for the wrong type")
    require(launches["bsr_matvec"] == op_calls
            and launches["bsr_rmatmul"] == op_calls
            and launches["bsr_matmul"] == 1,
            f"coordinate: launches {launches} for {op_calls} operator calls")
    # One product of each kind, timed alone.
    v = torch.randn(N_C, device=dev)
    u = torch.randn(M_C, device=dev)
    same = (torch.equal(C.matvec(v), C.matvec(v))
            and torch.equal(C.rmatvec(u), C.rmatvec(u)))
    out["coo_products_repeat_bits"] = same
    require(same, "coordinate: two products of C differ in their bits")
    out["coo_matvec_ms"] = time_ms(lambda: C.matvec(v))
    out["coo_rmatvec_ms"] = time_ms(lambda: C.rmatvec(u))
    out["bsr_matvec_ms"] = time_ms(lambda: S_c.matvec(v))
    out["bsr_rmatvec_ms"] = time_ms(lambda: S_c.rmatvec(u))
    print(f"[coordinate] A v {out['coo_matvec_ms']:.3f} ms, A^T u "
          f"{out['coo_rmatvec_ms']:.3f} ms (segment sums, same bits each "
          f"call); bs {BS_S}: "
          f"{out['bsr_matvec_ms']:.3f}, {out['bsr_rmatvec_ms']:.3f} ms")
    return out


def run_block(ops, dev) -> tuple[dict, dict]:
    """(f) BlockMatrix.multiply of two N_BLOCK x N_BLOCK f32 matrices (one
    gemm launch) against a float64 product, timed beside torch.mm and the
    route's bound; returns (path record, gemm check record)."""
    from repro_torch.core.distmat import BlockMatrix

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    a = torch.randn(N_BLOCK, N_BLOCK, generator=gen, device=dev)
    b = torch.randn(N_BLOCK, N_BLOCK, generator=gen, device=dev)
    X = BlockMatrix.create(a, device=dev)
    Y = BlockMatrix.create(b, device=dev)
    ops.reset_launch_counts()
    P = X.multiply(Y)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # ------------------------------------------------------------------
    want = a.double() @ b.double()
    err = rel_err(P.data, want)
    mad = max_abs(P.data, want)
    del want
    ms = time_ms(lambda: X.multiply(Y))
    mm_ms = time_ms(lambda: torch.mm(a, b))
    plain = torch.empty_like(a)
    from repro_torch.kernels import gemm as _gemm
    plain_ms = time_ms(lambda: plain.copy_(_gemm.gemm_plain(a, b)))
    flops = 2.0 * N_BLOCK ** 3
    nbytes = 3.0 * N_BLOCK * N_BLOCK * 4
    bound_ms, by = bound(nbytes, 3 * flops, "tf32")
    fma_ms, _ = bound(nbytes, flops, torch.float32)
    rec = {"max_abs_err": mad, "rel_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": by, "fma_bound_ms": fma_ms,
           "library_ms": mm_ms, "shape": [N_BLOCK, N_BLOCK, N_BLOCK]}
    print(f"[block] {N_BLOCK}^2 @ {N_BLOCK}^2 (one gemm launch: "
          f"{launches['gemm']}): {ms:.3f} ms, torch.mm {mm_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({by}, 3xTF32; f32 "
          f"FMA {fma_ms:.3f}), {err:.3e} normwise from float64")
    require(err <= 1e-4, f"block: {err:.3e} from the float64 product")
    require(launches["gemm"] == 1, f"block: launches {launches}")
    return {"launches": launches, "gemm": rec}, rec


def run_front_doors(api, ops, dev, sigma3: torch.Tensor) -> dict:
    """(f)'s IndexedRowMatrix SVD and (g): phase 3's A made again from its
    seed; api.compute_svd against api.svd bit for bit, the Lanczos SVD of
    the IndexedRowMatrix over A against the Gram sigma; then serve.main on
    the card."""
    from repro_torch.core.distmat import IndexedRowMatrix, RowMatrix
    from repro_torch.launch import serve

    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = 1.0 + 2.0 * 0.95 ** torch.arange(N, device=dev, dtype=torch.float32)
    A = torch.randn(M, N, generator=gen, device=dev)
    A.mul_(d / math.sqrt(N))
    rm = RowMatrix.create(A, device=dev)
    want = api.svd(api.SvdRequest(A=rm, k=K_SVD, mode="gram", device=dev))
    require(torch.equal(want.factors[1], sigma3),
            "front doors: A made again gives another Gram sigma")
    ops.reset_launch_counts()
    U, s, V, info = api.compute_svd(rm, K_SVD, mode="gram", device=dev)
    torch.cuda.synchronize()
    svd_launches = ops.launch_counts()
    # ------------------------------------------------------------------
    same = (torch.equal(s, want.factors[1]) and torch.equal(V, want.factors[2])
            and torch.equal(U.rows, want.factors[0].rows))
    print(f"[front doors] api.compute_svd(mode='gram') against api.svd: "
          f"same bits {same}; launches {svd_launches}")
    require(same, "front doors: compute_svd and svd differ")
    irm = IndexedRowMatrix.create(torch.arange(M, device=dev), A, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Ui, si, Vi, infoi = api.compute_svd(irm, K_SVD, device=dev,
                                        max_restarts=COO_RESTARTS)
    torch.cuda.synchronize()
    irm_ms = (time.perf_counter() - t0) * 1e3
    rel = float(((si.double() - sigma3.double()).abs()
                 / sigma3.double()).max())
    irm_rec = {"ms": irm_ms, "mode": infoi["mode"],
               "restarts": infoi["restarts"], "op_calls": infoi["op_calls"],
               "converged": infoi["converged"], "sigma_rel_to_gram": rel}
    print(f"[front doors] IndexedRowMatrix over A: Lanczos SVD k={K_SVD} "
          f"{irm_ms:.1f} ms, {infoi['restarts']} restarts, "
          f"{infoi['op_calls']} operator calls, sigma {rel:.3e} from the "
          f"Gram sigma")
    require(infoi["mode"] == "lanczos" and Ui is None,
            f"indexed: mode {infoi['mode']}, U {Ui is not None}")
    require(rel <= 1e-4, f"indexed: sigma {rel:.3e} from the Gram sigma")
    del A, rm, irm, want, U, V, Vi
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server = serve.main(SERVE_ARGS + ["--device", str(dev)])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = ops.launch_counts()
    # ------------------------------------------------------------------
    served = len(server.latencies())
    serve_rec = {"args": SERVE_ARGS, "s": serve_s, "served": served,
                 "stats": {k: v for k, v in server.stats.items()
                           if k != "degraded"},
                 "launches": serve_launches}
    print(f"[front doors] serve.main {' '.join(SERVE_ARGS)}: {served} "
          f"served in {serve_s:.1f} s, group A-passes "
          f"{server.stats['a_passes']}, launches {serve_launches}")
    require(served == 16 and server.stats["admitted"] == 16,
            f"serve.main: {served} served")
    require(serve_launches["fused_grad_multi"] == server.stats["a_passes"],
            f"serve.main: {serve_launches['fused_grad_multi']} "
            f"fused_grad_multi launches, {server.stats['a_passes']} A-passes")
    return {"svd_launches": svd_launches, "indexed": irm_rec,
            "serve": serve_rec}


def run_phase9(api, ops, dev, sigma3) -> tuple[dict, dict, dict]:
    """Phase 9 (a)-(g); returns (record, launches by path, gemm's
    check)."""
    t9 = time.perf_counter()
    ops.reset_launch_counts()
    fig1 = run_figure1(api, ops, dev)
    torch.cuda.synchronize()
    paths = {"fd_figure1": ops.launch_counts()}
    # ------------------------------------------------------------------
    ops.reset_launch_counts()
    linear, p = run_linear_full(api, ops, dev)
    torch.cuda.synchronize()
    paths["fd_linear"] = ops.launch_counts()
    # ------------------------------------------------------------------
    ops.reset_launch_counts()
    lasso = run_lasso(ops, p.linop.A, dev)
    torch.cuda.synchronize()
    paths["fd_lasso"] = ops.launch_counts()
    # ------------------------------------------------------------------
    del p
    torch.cuda.empty_cache()
    lp = run_lp(dev)
    torch.cuda.empty_cache()
    coo = run_coordinate(api, ops, dev)
    paths["fd_coordinate"] = coo["launches"]
    torch.cuda.empty_cache()
    block, gemm_rec = run_block(ops, dev)
    paths["fd_block"] = block["launches"]
    torch.cuda.empty_cache()
    doors = run_front_doors(api, ops, dev, sigma3)
    paths["fd_svd"] = doors["svd_launches"]
    paths["fd_serve"] = doors["serve"]["launches"]
    for path, names in PATHS.items():
        if path.startswith("fd_"):
            for name in names:
                require(paths[path][name] > 0,
                        f"{name} never launched on the {path} path")
    rec = {"figure1": fig1, "linear": linear, "lasso": lasso, "lp": lp,
           "coordinate": coo, "block": block, "front_doors": doors,
           "s": time.perf_counter() - t9}
    print(f"[front door] phase 9 in {rec['s']:.1f} s")
    return rec, paths, gemm_rec


# -- phase 8: LM serving ----------------------------------------------------

def attn_inputs(params, cfg, tokens):
    """Layer 0's real q (B·Hq, S, D) and k, v (B·Hkv, S, D) for `tokens`,
    as the prefill gives them to flash_attention (MLA: the materialized
    form, D = 192, v zero-padded; hybrid: the shared block's first
    application), the scale (None: 1/√D) and the q heads a KV head."""
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA

    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    if cfg.family == "hybrid":       # group 0's shared attention block
        lp = params["shared_attn"]
    else:
        lp = params["dense_prefix" if cfg.moe else "blocks"][0]
    h = L.apply_norm(lp["norm1"], L.embed(params["embed"], tokens, cfg), cfg)
    if cfg.mla:
        *qkv, scale = MLA.flash_inputs(lp["attn"], h, pos, cfg)
        group = 1
    else:
        qkv = [t.transpose(1, 2) for t in L._qkv(lp["attn"], h, pos, cfg)]
        scale, group = None, cfg.num_heads // cfg.num_kv_heads
    return ([t.reshape(-1, S, t.shape[-1]).contiguous() for t in qkv]
            + [scale, group])


def scan_inputs(params, cfg, tokens):
    """Layer 0's real (x, dt, A, B, C, D) for `tokens`, as the prefill
    gives them to selective_scan."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM

    lp = params["blocks"][0]
    h = L.apply_norm(lp["norm1"], L.embed(params["embed"], tokens, cfg), cfg)
    xr = (h @ lp["mixer"]["w_in"]).chunk(2, -1)[0]
    xc = F.silu(SSM._causal_conv(xr.float(), lp["mixer"]["conv_w"],
                                 lp["mixer"]["conv_b"])).to(h.dtype)
    di, N, dt_rank = SSM._dims(cfg)
    dt, A, Bm, Cm = SSM._scan_inputs(lp["mixer"], xc, dt_rank, N)
    return xc.float().contiguous(), dt, A, Bm, Cm, lp["mixer"]["D"]


def check_flash(params, cfg, tokens) -> dict:
    """flash_attention against its plain version on layer 0's real q, k,
    v: bf16 (the path's type) and f32 at the path's S, bf16 at S + 1
    (ragged), and bf16 causal with S queries against S + 1 keys; times at
    the path's shape beside SDPA (its longest device kernel named) and
    the bound.  At MLA's D = 192 the output's padded columns must be 0."""
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for key, toks, dtype in (("bf16", tokens[:, :LM_PROMPT], None),
                             ("f32", tokens[:, :LM_PROMPT], torch.float32),
                             ("bf16_ragged", tokens, None),
                             ("bf16_sq_ne_sk", tokens, None)):
        q, k, v, scale, g = attn_inputs(params, cfg, toks)
        if dtype is not None:
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        if key == "bf16_sq_ne_sk":
            # 2048 queries against 2049 keys (causal, top-left): layer 0's
            # real q for the first S positions, k and v for all S + 1.
            q = q[:, :LM_PROMPT].contiguous()
        got = fa.flash_attention(q, k, v, scale=scale, q_heads_per_kv=g)
        want = plain_by_heads(q, k, v, scale, g)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        lim = TOL_LM["flash_f32" if dtype else "flash_bf16"]
        padded = bool(cfg.mla) and bool(got[..., cfg.mla.v_head_dim:].any())
        D = q.shape[-1]
        require(bool(torch.isfinite(got).all()) and e <= lim and not padded,
                f"{cfg.name} flash_attention D = {D} {key}: relative error "
                f"{e:.3e} > {lim} (or padded columns nonzero)")
        rec = {"rel_err": e, "max_abs_err": max_abs(got, want),
               "shape": list(q.shape), "group": g,
               "variant": fa.VARIANTS[q.dtype]}
        if key == "bf16_sq_ne_sk":
            rec["kv_shape"] = list(k.shape)
        del got, want
        if key in ("bf16", "f32"):
            time_flash(rec, q, k, v, scale, g, True, toks.shape[0])
            print(f"[lm] {cfg.name} flash_attention D = {D} {key} "
                  f"({rec['variant']}): {flash_times(rec)} | rel err "
                  f"{e:.2e}")
        else:
            print(f"[lm] {cfg.name} flash_attention D = {D} {key} "
                  f"({rec['variant']}; Sq = {q.shape[1]}, Sk = "
                  f"{k.shape[1]}): rel err {e:.2e}")
        out[key] = rec
        del q, k, v
    return out


def time_flash(rec: dict, q, k, v, scale, g: int, causal: bool,
               B: int) -> None:
    """Into rec: flash_attention's median ms on (q, k, v), its plain
    version's, SDPA's (with the longest device kernel it ran) and the
    bound (4·D flops a live query-key pair; q and o, k and v once)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    bhq, sq, D = q.shape
    sk = k.shape[1]
    pairs = bhq * (sq * (sq + 1) / 2 if causal else sq * sk)   # Sq <= Sk
    rec["bound_ms"], rec["bound_by"] = bound(
        (2 * q.numel() + 2 * k.numel()) * q.element_size(),
        4.0 * D * pairs, q.dtype)
    rec["ms"] = time_ms(lambda: fa.flash_attention(
        q, k, v, scale=scale, causal=causal, q_heads_per_kv=g))
    rec["plain_ms"] = time_ms(lambda: plain_by_heads(q, k, v, scale, g,
                                                     causal), reps=3)
    q4 = q.reshape(B, -1, sq, D)
    k4, v4 = (t.reshape(B, -1, sk, D) for t in (k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale, enable_gqa=True)
    rec["library_ms"], rec["library_error"] = library_time(sdpa)
    rec["library_kernel"] = (sdpa_kernel_name(sdpa) if rec["library_ms"]
                             else None)


def flash_times(rec: dict) -> str:
    """time_flash's numbers as one line of text."""
    sdpa_s = (f"{rec['library_ms']:.3f} ({rec['library_kernel']})"
              if rec["library_ms"] else rec["library_error"])
    return (f"kernel {rec['ms']:.3f} ms | plain {rec['plain_ms']:.3f} | "
            f"SDPA {sdpa_s} | bound {rec['bound_ms']:.3f} "
            f"({rec['bound_by']}), share {rec['bound_ms'] / rec['ms']:.3f}")


def mamba2_inputs(params, cfg, tokens):
    """zamba2's first Mamba2 layer's real (x, dt, A, B, C, D) for
    `tokens`, as the prefill gives them to selective_scan: its input is
    the shared attention block's output (flash launches outside any
    counted window)."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TF

    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    x, _ = TF.apply_block(params["shared_attn"],
                          L.embed(params["embed"], tokens, cfg), pos, cfg,
                          "dense")
    lp = params["groups"][0]["mamba"][0]
    p = lp["mixer"]
    h = L.apply_norm(lp["norm1"], x, cfg)
    conv = [F.silu(SSM._causal_conv((h @ p[w]).float(), p[c], p[b]))
            for w, c, b in (("w_x", "conv_w", "conv_b"),
                            ("w_B", "convB_w", "convB_b"),
                            ("w_C", "convC_w", "convC_b"))]
    dt = F.softplus(h.float() @ p["w_dt"] + p["dt_bias"])
    return SSM.mamba2_scan_inputs(p, *conv, dt, cfg)


def ssd_chunked(x, dt, A, B, C, D, Pd: int, chunk: int) -> torch.Tensor:
    """The reference's chunked SSD form of Mamba2's prefill (src/repro/
    models/ssm.py:279-326, from a zero state) in plain torch, on
    selective_scan's per-channel arguments (dt, A and D repeated over each
    head's Pd channels): y (Bt, S, d).  Timed beside the kernel for the
    later redesign; not on any path."""
    Bt, S, d = x.shape
    H, N = d // Pd, B.shape[-1]
    Q = chunk if S % chunk == 0 else max(
        q for q in range(1, min(chunk, S) + 1) if S % q == 0)
    nc = S // Q
    xh = x.reshape(Bt, nc, Q, H, Pd)
    dtc = dt[..., ::Pd].reshape(Bt, nc, Q, H)
    Bch, Cch = B.reshape(Bt, nc, Q, N), C.reshape(Bt, nc, Q, N)
    cs = torch.cumsum(dtc * A[::Pd, 0], 2)
    x_disc = xh * dtc[..., None]
    csh = cs.transpose(2, 3)
    diff = csh[..., :, None] - csh[..., None, :]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    Lm = torch.where(tri, torch.exp(diff), 0.0)
    M = torch.einsum("bcqn,bckn->bcqk", Cch, Bch)[:, :, None] * Lm
    y = torch.einsum("bchqk,bckhp->bcqhp", M, x_disc)
    del diff, Lm, M
    last = cs[:, :, -1:, :]
    S_c = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bch, torch.exp(last - cs),
                       x_disc)
    decay = torch.exp(last[:, :, 0])
    h = torch.zeros(Bt, H, N, Pd, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = decay[:, c, :, None, None] * h + S_c[:, c]
    y = y + torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cch, torch.exp(cs),
                         torch.stack(prev, 1))
    return y.reshape(Bt, S, d) + D * x


def check_scan(params, cfg, tokens) -> dict:
    """selective_scan against its plain version on the first SSM layer's
    real inputs at the path's S and at S + 1 (ragged), and for Mamba2
    (N = 64) from a nonzero state too: y and the final state; times at
    the path's shape beside the bound, and for Mamba2 beside the
    reference's chunked SSD form in plain torch (which must agree)."""
    from repro_torch.kernels import selective_scan as ss

    mamba2 = cfg.family == "hybrid"
    inputs = mamba2_inputs if mamba2 else scan_inputs
    cases = [("f32", tokens[:, :LM_PROMPT], False)]
    if mamba2:
        cases.append(("f32_h0", tokens[:, :LM_PROMPT], True))
    cases.append(("f32_ragged", tokens, False))
    out = {}
    for key, toks, with_h0 in cases:
        args = inputs(params, cfg, toks)
        Bt, S, d = args[0].shape
        N = args[2].shape[1]
        h0 = (torch.randn(Bt, d, N, device=toks.device,
                          generator=torch.Generator(device=toks.device)
                          .manual_seed(SEED + 10)) * 0.5
              if with_h0 else None)
        y, h = ss.selective_scan(*args, h0=h0)
        y0, h0_ = ss.selective_scan_plain(*args, h0=h0)
        torch.cuda.synchronize()
        e_y, e_h = rel_err(y, y0), rel_err(h, h0_)
        require(bool(torch.isfinite(y).all()) and e_y <= TOL_LM["scan"]
                and e_h <= TOL_LM["scan"],
                f"selective_scan N = {N} {key}: relative error y {e_y:.3e}, "
                f"final state {e_h:.3e} > {TOL_LM['scan']}")
        rec = {"rel_err": {"y": e_y, "h": e_h},
               "max_abs_err": max(max_abs(y, y0), max_abs(h, h0_)),
               "shape": [Bt, S, d, N]}
        del y0, h0_
        if key == "f32":
            t_bytes = (3 * Bt * S * d + 2 * Bt * S * N + d * N + d
                       + Bt * d * N) * 4 / HBM_BYTES_PER_S * 1e3
            t_exp = Bt * S * d * N / EXP_PER_S * 1e3
            rec["bound_ms"], rec["bound_by"] = (
                (t_bytes, "bytes") if t_bytes >= t_exp
                else (t_exp, "operations"))
            rec["ms"] = time_ms(lambda: ss.selective_scan(*args))
            rec["plain_ms"] = time_ms(lambda: ss.selective_scan_plain(*args),
                                      reps=3)
            rec["library_ms"] = None   # no one torch call runs the scan
            extra = ""
            if mamba2:
                def ssd():
                    return ssd_chunked(*args, cfg.ssm.head_dim,
                                       cfg.ssm.chunk)
                e_ssd = rel_err(ssd(), y)
                require(e_ssd <= TOL_LM["ssd"], f"the chunked SSD form is "
                        f"{e_ssd:.3e} from selective_scan N = {N}")
                rec["ssd_chunked_ms"] = time_ms(ssd, reps=3)
                rec["ssd_rel_err"] = e_ssd
                extra = (f" | chunked SSD (plain torch, chunk "
                         f"{cfg.ssm.chunk}) {rec['ssd_chunked_ms']:.3f}, "
                         f"{e_ssd:.2e} from the kernel")
            print(f"[lm] selective_scan N = {N} {key} ({Bt} x {S} x {d}): "
                  f"kernel {rec['ms']:.3f} ms | plain {rec['plain_ms']:.3f}"
                  f"{extra} | bound {rec['bound_ms']:.3f} "
                  f"({rec['bound_by']}; bytes {t_bytes:.3f}, exp "
                  f"{t_exp:.3f}), share {rec['bound_ms'] / rec['ms']:.3f} | "
                  f"rel err y {e_y:.2e}, h {e_h:.2e}")
        else:
            print(f"[lm] selective_scan N = {N} {key} (S = {S}"
                  f"{', from a nonzero state' if with_h0 else ''}): rel err "
                  f"y {e_y:.2e}, h {e_h:.2e}")
        out[key] = rec
        del args, y, h
    return out


def check_flash_noncausal(params, cfg, tokens, frames) -> dict:
    """flash_attention non-causal against its plain version on
    seamless's real inputs, bf16 (the path's type) and f32: the encoder's
    layer-0 self-attention over `frames` (Sq = Sk) and the decoder's
    layer-0 cross-attention, LM_PROMPT queries against the memory of
    LM_ENC_FRAMES frames; each timed beside SDPA and the bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L

    B, S = tokens.shape[0], LM_PROMPT
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    enc, dec = params["encoder"][0], params["decoder"][0]
    x = frames[:, :S].to(L.pdtype(cfg))
    q, k, v = L._qkv(enc["attn"], L.apply_norm(enc["norm1"], x, cfg), pos,
                     cfg)
    memory = ED.encode(params, frames[:, :LM_ENC_FRAMES], cfg)
    ck, cv = ED._cross_kv(dec, memory, cfg)
    x = L.embed(params["embed"], tokens[:, :S], cfg)
    a, _ = L.attention(dec["self_attn"], L.apply_norm(dec["norm1"], x, cfg),
                       pos, cfg)
    xq = L.apply_norm(dec["norm_x"], x + a, cfg) @ dec["cross_attn"]["wq"]
    flat = [t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
            for t in (q, k, v, xq.reshape(B, S, H, hd), ck, cv)]
    del q, k, v, memory, ck, cv, x, a, xq
    out = {}
    for key, (q, k, v) in (("self", flat[:3]), ("cross", flat[3:])):
        for dt in ("bf16", "f32"):
            qd, kd, vd = ((t.float() for t in (q, k, v)) if dt == "f32"
                          else (q, k, v))
            g = qd.shape[0] // kd.shape[0]
            got = fa.flash_attention(qd, kd, vd, causal=False,
                                     q_heads_per_kv=g)
            want = plain_by_heads(qd, kd, vd, None, g, causal=False)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            lim = TOL_LM[f"flash_{dt}"]
            require(bool(torch.isfinite(got).all()) and e <= lim,
                    f"{cfg.name} flash_attention non-causal {key} {dt}: "
                    f"relative error {e:.3e} > {lim}")
            rec = {"rel_err": e, "max_abs_err": max_abs(got, want),
                   "shape": list(qd.shape), "kv_shape": list(kd.shape),
                   "group": g, "variant": fa.VARIANTS[qd.dtype]}
            del got, want
            time_flash(rec, qd, kd, vd, None, g, False, B)
            print(f"[lm] {cfg.name} flash_attention D = {hd} non-causal "
                  f"{key} {dt} (Sq = {qd.shape[1]}, Sk = {kd.shape[1]}; "
                  f"{rec['variant']}): {flash_times(rec)} | rel err {e:.2e}")
            out[f"{dt}_{key}"] = rec
            del qd, kd, vd
    return out


def new_caches(model, batch: int, max_len: int, fe=None):
    """Empty caches for `max_len` positions; an encdec model's cross K/V
    sized by its frames `fe`."""
    if model.cfg.family == "encdec":
        return model.init_caches(batch, max_len, fe.shape[1])
    return model.init_caches(batch, max_len)


def pvd_logits(model, params, tokens, fe=None):
    """The last-position logits (over the real vocabulary) of
    prefill(tokens[:, :S]) then decode_step(tokens[:, S]) (the plain
    one-token path) and of prefill(tokens[:, :S+1]) (the kernel path), in
    that order; the calls run long prefill, short prefill, decode.  Both
    prefills take the frontend stub's `fe` (encdec: the encoder's
    frames)."""
    B, S1 = tokens.shape
    extra = {} if fe is None else {"frontend_embeds": fe}
    with torch.inference_mode():
        want, _ = model.prefill(params, {"tokens": tokens, **extra},
                                new_caches(model, B, S1, fe))
        _, caches = model.prefill(params, {"tokens": tokens[:, :-1],
                                           **extra},
                                  new_caches(model, B, S1, fe))
        got, _ = model.decode_step(params, tokens[:, -1:], caches, S1 - 1)
    V = model.cfg.vocab_size
    return got[..., :V], want[..., :V]


def prefill_vs_decode(model, params, tokens, fe=None) -> float:
    """Normwise relative difference of pvd_logits' two logits."""
    return rel_err(*pvd_logits(model, params, tokens, fe))


def run_lm(dev) -> dict:
    """Phase 8: greedy generation on llama3.2-3b and falcon-mamba-7b at
    full width and depth in bf16 (random weights from a seed), each model
    alone on the card; then each kernel against its plain version on
    layer 0's real inputs, and prefill against decode at full size (bf16)
    and at full width and LM_F32_LAYERS layers in f32.  Then the moe
    family (run_lm_moe), the registered dense/vlm configurations
    (run_lm_configs) and the hybrid and encdec families
    (run_lm_families)."""
    from repro_torch import configs
    from repro_torch.launch.serve_llm import generate
    from repro_torch.models import build

    out = {"models": {}, "kernels": {}}
    for arch, kernel in LM_MODELS.items():
        cfg = configs.get(arch)
        model = build(cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        t0 = time.perf_counter()
        params = model.init(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                               generator=gen, device=dev)
        prompt = tokens[:, :LM_PROMPT]
        toks, times, counts, variants, _ = lm_path(
            model, params, prompt, arch, {kernel: cfg.num_layers})
        decode_launches_nothing(model, params, prompt, arch)
        warm = generate(model, params, prompt, LM_GEN)[1]
        rec = {"init_s": init_s, "launches": counts,
               "flash_attention_variant_launches": variants, "cold": times,
               "warm": warm,
               "params_b": sum(p.numel() for p in params.parameters()) / 1e9,
               "prefill_tokens_per_s": LM_BATCH * LM_PROMPT
               / (warm["prefill_ms"] / 1e3),
               "decode_tokens_per_s": LM_BATCH
               / (warm["decode_ms_per_token"] / 1e3),
               "tokens_row0": toks[0].tolist()}
        print(f"[lm] {arch}: {rec['params_b']:.2f} B parameters (init "
              f"{init_s:.1f} s); prefill {warm['prefill_ms']:.1f} ms for "
              f"{LM_BATCH}x{LM_PROMPT} ({rec['prefill_tokens_per_s']:.0f} "
              f"tokens/s), decode {warm['decode_ms_per_token']:.2f} "
              f"ms/token ({rec['decode_tokens_per_s']:.1f} tokens/s at batch "
              f"{LM_BATCH}); cold prefill {times['prefill_ms']:.1f} ms")

        check = check_flash if kernel == "flash_attention" else check_scan
        out["kernels"][kernel] = check(params, cfg, tokens)
        out["kernels"][kernel]["launches"] = counts[kernel]
        if kernel == "flash_attention":
            out["kernels"][kernel]["variant_launches"] = variants
        e = prefill_vs_decode(model, params, tokens)
        rec["prefill_vs_decode_bf16"] = e
        require(e <= TOL_LM["pvd_bf16"], f"{arch}: bf16 prefill against "
                f"decode {e:.3e} > {TOL_LM['pvd_bf16']}")
        del model, params, tokens, prompt
        torch.cuda.empty_cache()

        cfg32 = cfg.scaled(num_layers=LM_F32_LAYERS, dtype="float32")
        model = build(cfg32, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED + 9))
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                               generator=gen, device=dev)
        e = prefill_vs_decode(model, params, tokens)
        rec["prefill_vs_decode_f32"] = e
        require(e <= TOL_LM["pvd_f32"], f"{arch}: f32 prefill against "
                f"decode ({LM_F32_LAYERS} layers) {e:.3e} > "
                f"{TOL_LM['pvd_f32']}")
        print(f"[lm] {arch}: prefill against decode, last-position logits: "
              f"bf16 {rec['prefill_vs_decode_bf16']:.3e} (limit "
              f"{TOL_LM['pvd_bf16']}), f32 at {LM_F32_LAYERS} layers "
              f"{e:.3e} (limit {TOL_LM['pvd_f32']})")
        out["models"][arch] = rec
        del model, params, tokens
        torch.cuda.empty_cache()
    run_lm_moe(dev, out)
    run_lm_configs(dev, out)
    run_lm_families(dev, out)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def plain_by_heads(q, k, v, scale=None, group=1, causal=True):
    """flash_attention_plain on PLAIN_HEADS KV heads (and their q heads) a
    call, so its f32 scores stay small beside the weights."""
    from repro_torch.kernels import flash_attention as fa

    return torch.cat([fa.flash_attention_plain(
        q[h * group:(h + PLAIN_HEADS) * group], k[h:h + PLAIN_HEADS],
        v[h:h + PLAIN_HEADS], scale=scale, causal=causal,
        q_heads_per_kv=group)
        for h in range(0, k.shape[0], PLAIN_HEADS)])


def sdpa_kernel_name(fn) -> str:
    """The longest device kernel of one call of `fn` under torch.profiler
    (which SDPA backend ran), or "not measured" when the trace shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type != torch.autograd.DeviceType.CPU]
    except (RuntimeError, AssertionError):
        return "not measured"
    if not rows:
        return "not measured"
    return max(rows, key=lambda e: e.device_time_total).key[:160]


def lm_path(model, params, prompt, arch, want: dict, fe=None):
    """generate on the main path: counts zeroed just before and read just
    after; each kernel of `want` launched as often as it says (in prefill
    only; flash_attention on its tensor-core variant) and no other kernel;
    greedy tokens inside the vocabulary.  Returns (tokens, times, counts,
    variants, masks): flash_attention's launches by variant and by
    mask."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_llm import generate

    cfg = model.cfg
    # -- the main path: counts zeroed just before, read just after --------
    ops.reset_launch_counts()
    toks, times = generate(model, params, prompt, LM_GEN, fe)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    variants = dict(fa.flash_attention.variant_launches)
    masks = dict(fa.flash_attention.mask_launches)
    # ----------------------------------------------------------------------
    print(f"[main path] {arch}: launches {counts}; flash_attention by "
          f"variant {variants}, by mask {masks}")
    for name, c in counts.items():
        require(c == want.get(name, 0), f"{arch}: {name} launched {c} "
                f"times in one generate, want {want.get(name, 0)} (in "
                "prefill only)")
    # The bf16 prefill runs the tensor-core variant alone.
    tc = fa.VARIANTS[torch.bfloat16]
    for name, c in variants.items():
        want = counts["flash_attention"] if name == tc else 0
        require(c == want, f"{arch}: flash_attention variant {name} "
                f"launched {c} times in one generate, want {want}")
    require(toks.shape == (prompt.shape[0], LM_GEN)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{arch}: greedy tokens outside the vocabulary")
    return toks, times, counts, variants, masks


def decode_launches_nothing(model, params, prompt, arch, fe=None) -> None:
    """A decode step alone (after a 64-token prefill, with the frontend
    stub's `fe`) launches no kernel and gives finite logits."""
    from repro_torch.kernels import ops

    batch = {"tokens": prompt[:, :64]}
    if fe is not None:
        batch["frontend_embeds"] = fe
    with torch.inference_mode():
        caches = new_caches(model, prompt.shape[0], 65, fe)
        logits, caches = model.prefill(params, batch, caches)
        ops.reset_launch_counts()
        logits, _ = model.decode_step(
            params, logits[:, -1].argmax(-1, keepdim=True), caches, 64)
        torch.cuda.synchronize()
    require(not any(ops.launch_counts().values()),
            f"{arch}: a decode step launched {ops.launch_counts()}")
    require(bool(torch.isfinite(logits[..., :model.cfg.vocab_size]).all()),
            f"{arch}: decode logits not finite")


def pvd_moe(model, params, tokens, mode: str, capacity_factor: float) -> dict:
    """Prefill against decode of a MoE model at `capacity_factor` with MLA
    decode mode `mode` (the same weights): the logits' normwise
    difference over every row ("all") and over the rows whose last token
    went to the same experts in the long prefill and in the decode step at
    every MoE layer ("agreeing", None where there is none), those rows,
    and the token-expert pairs the three calls dropped."""
    import dataclasses
    from repro_torch.models import build
    from repro_torch.models import moe as MOE

    cfg = model.cfg
    wide = build(cfg.scaled(mla_decode_mode=mode, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor)), device=model.device)
    B, S1 = tokens.shape
    with MOE.RoutingTally() as tally:
        got, want = pvd_logits(wide, params, tokens)
    n = len(tally.calls) // 3
    same = torch.ones(B, dtype=torch.bool, device=tokens.device)
    for long, step in zip(tally.calls[:n], tally.calls[2 * n:]):
        last = long["experts"].reshape(B, S1, -1)[:, -1]
        same &= (last == step["experts"]).all(-1)
    rows = same.nonzero().flatten().tolist()
    return {"all": rel_err(got, want),
            "agreeing": rel_err(got[rows], want[rows]) if rows else None,
            "agreeing_rows": rows, "dropped": tally.dropped}


def hold_pvd(arch: str, what: str, r: dict, limit: float,
             every_row: bool) -> None:
    """Print a pvd_moe reading and hold it: nothing dropped, and within
    `limit` over every row (every_row) or over the agreeing rows, of
    which there must be one."""
    agree = ("none" if r["agreeing"] is None else
             f"{r['agreeing']:.3e} on rows {r['agreeing_rows']}")
    print(f"[lm] {arch}: prefill against {what}: all rows {r['all']:.3e}, "
          f"rows routed alike {agree} (limit {limit} on "
          f"{'every row' if every_row else 'the rows routed alike'}; "
          f"{r['dropped']} pairs dropped)")
    e = r["all"] if every_row else r["agreeing"]
    require(r["dropped"] == 0 and e is not None and e <= limit,
            f"{arch}: prefill against {what}: {e} > {limit}, or "
            f"{r['dropped']} pairs dropped")


def run_lm_moe(dev, out: dict) -> None:
    """Phase 8, the moe family: deepseek-v2-236b and deepseek-v3-671b at
    full width and LM_MOE_LAYERS layers in bf16 (random weights from a
    seed), each alone on the card: generate with the MoE drop share,
    flash_attention at D = 192 against its plain version on layer 0's
    real inputs, prefill against decode in bf16 and in f32 at
    LM_F32_LAYERS layers, and (v2) a second generate in materialize decode
    mode."""
    from repro_torch import configs
    from repro_torch.launch.serve_llm import generate
    from repro_torch.models import build
    from repro_torch.models import moe as MOE

    for arch, layers in LM_MOE_LAYERS.items():
        t_model = time.perf_counter()
        cfg = configs.get(arch).scaled(num_layers=layers)
        model = build(cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        t0 = time.perf_counter()
        params = model.init(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                               generator=gen, device=dev)
        prompt = tokens[:, :LM_PROMPT]
        with MOE.RoutingTally() as tally:
            toks, times, counts, variants, _ = lm_path(
                model, params, prompt, arch,
                {"flash_attention": cfg.num_layers})
        n_moe = cfg.num_layers - cfg.moe.first_k_dense
        pre, dec = tally.calls[:n_moe], tally.calls[n_moe:]
        drops = {"prefill_pairs": sum(c["pairs"] for c in pre),
                 "prefill_dropped": sum(c["dropped"] for c in pre),
                 "prefill_max_load": [c["max_load"] for c in pre],
                 "prefill_capacity": pre[0]["capacity"],
                 "decode_pairs": sum(c["pairs"] for c in dec),
                 "decode_dropped": sum(c["dropped"] for c in dec)}
        del tally
        drops["prefill_share"] = (drops["prefill_dropped"]
                                  / drops["prefill_pairs"])
        decode_launches_nothing(model, params, prompt, arch)
        warm = generate(model, params, prompt, LM_GEN)[1]
        rec = {"layers": cfg.num_layers, "init_s": init_s,
               "launches": counts,
               "flash_attention_variant_launches": variants, "cold": times,
               "warm": warm, "moe_drops": drops,
               "params_b": sum(p.numel() for p in params.parameters()) / 1e9,
               "prefill_tokens_per_s": LM_BATCH * LM_PROMPT
               / (warm["prefill_ms"] / 1e3),
               "decode_tokens_per_s": LM_BATCH
               / (warm["decode_ms_per_token"] / 1e3),
               "tokens_row0": toks[0].tolist()}
        print(f"[lm] {arch} ({cfg.num_layers} layers, "
              f"{cfg.moe.first_k_dense} dense): {rec['params_b']:.2f} B "
              f"parameters (init {init_s:.1f} s); prefill "
              f"{warm['prefill_ms']:.1f} ms for {LM_BATCH}x{LM_PROMPT} "
              f"({rec['prefill_tokens_per_s']:.0f} tokens/s), decode "
              f"{warm['decode_ms_per_token']:.2f} ms/token; cold prefill "
              f"{times['prefill_ms']:.1f} ms; dropped token-expert pairs: "
              f"prefill {drops['prefill_dropped']} of "
              f"{drops['prefill_pairs']} ({drops['prefill_share']:.5f}; "
              f"largest expert load a layer {drops['prefill_max_load']} "
              f"against capacity {drops['prefill_capacity']}), decode "
              f"{drops['decode_dropped']} of {drops['decode_pairs']}")
        if arch == "deepseek-v2-236b":
            mat = build(cfg.scaled(mla_decode_mode="materialize"),
                        device=dev)
            toks_m = generate(mat, params, prompt, LM_GEN)[0]
            same = int((toks_m[0] == toks[0]).sum())
            rec["materialize_tokens_row0"] = toks_m[0].tolist()
            rec["materialize_same_row0"] = same
            require(bool(((toks_m >= 0) & (toks_m < cfg.vocab_size)).all()),
                    f"{arch}: materialize-mode tokens outside the vocabulary")
            print(f"[lm] {arch} greedy tokens of row 0, absorbed decode: "
                  f"{toks[0].tolist()}")
            print(f"[lm] {arch} greedy tokens of row 0, materialize decode: "
                  f"{toks_m[0].tolist()} ({same} of {LM_GEN} the same)")
            del mat, toks_m
        d192 = check_flash(params, cfg, tokens)
        d192["launches"] = counts["flash_attention"]
        out["kernels"]["flash_attention"].setdefault("d192", {})[arch] = d192
        with MOE.RoutingTally() as t_pvd:
            e = prefill_vs_decode(model, params, tokens)
        rec["prefill_vs_decode_bf16_cf1.25"] = {"rel": e,
                                                "dropped": t_pvd.dropped}
        print(f"[lm] {arch}: prefill against decode at capacity_factor "
              f"{cfg.moe.capacity_factor}, bf16 {e:.3e} ({t_pvd.dropped} "
              "pairs dropped in the three calls; recorded, not held)")
        del t_pvd
        for mode in ("absorbed", "materialize"):
            r = pvd_moe(model, params, tokens, mode, PVD_CAPACITY_FACTOR)
            rec[f"prefill_vs_decode_bf16_{mode}"] = r
            hold_pvd(arch, f"{mode} decode at capacity_factor "
                     f"{PVD_CAPACITY_FACTOR}, bf16", r, TOL_LM["pvd_bf16"],
                     every_row=False)
        del model, params, tokens, prompt, toks
        torch.cuda.empty_cache()

        # f32 at LM_F32_LAYERS layers: the MTP block is left out (serving
        # never runs it, and v3's in f32 would not fit beside the rest).
        cfg32 = cfg.scaled(num_layers=LM_F32_LAYERS, dtype="float32",
                           mtp_depth=0)
        model = build(cfg32, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED + 9))
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                               generator=gen, device=dev)
        tokens = tokens[:1, :LM_F32_MOE_PROMPT + 1]
        every = math.ceil(cfg.moe.num_experts / cfg.moe.top_k)
        for mode in ("absorbed", "materialize"):
            r = pvd_moe(model, params, tokens, mode, every)
            rec[f"prefill_vs_decode_f32_{mode}"] = r
            hold_pvd(arch, f"{mode} decode at capacity_factor {every} "
                     f"(every token), f32 at {LM_F32_LAYERS} layers, one "
                     f"prompt of {tokens.shape[1]}", r, TOL_LM["pvd_f32"],
                     every_row=True)
        rec["s"] = time.perf_counter() - t_model
        out["models"][arch] = rec
        del model, params, tokens
        torch.cuda.empty_cache()


def run_lm_configs(dev, out: dict) -> None:
    """Phase 8, the registered dense/vlm configurations at full width
    (LM_CONFIGS' depths): one generate each, flash_attention once a
    layer; llava-next-34b with its frontend_len patch embeddings (the
    serving entry's frontend_embeds) in a prompt of LM_VLM_PROMPT."""
    from repro_torch import configs
    from repro_torch.launch.serve_llm import frontend_embeds
    from repro_torch.models import build

    for arch, layers in LM_CONFIGS.items():
        t_model = time.perf_counter()
        cfg = configs.get(arch)
        if layers is not None:
            cfg = cfg.scaled(num_layers=layers)
        model = build(cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        params = model.init(gen)
        S = LM_VLM_PROMPT if cfg.frontend else LM_PROMPT
        prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, S),
                               generator=gen, device=dev)
        fe = frontend_embeds(cfg, LM_BATCH, S, gen)
        toks, times, counts, _, _ = lm_path(
            model, params, prompt, arch, {"flash_attention": cfg.num_layers},
            fe)
        rec = {"layers": cfg.num_layers, "prompt": S, "launches": counts,
               "frontend_positions": None if fe is None else fe.shape[1],
               "cold": times,
               "params_b": sum(p.numel() for p in params.parameters()) / 1e9,
               "tokens_row0": toks[0].tolist(),
               "s": time.perf_counter() - t_model}
        print(f"[lm] {arch} ({cfg.num_layers} layers, {rec['params_b']:.2f} "
              f"B parameters, prompt {S}"
              + (f", {fe.shape[1]} frontend positions" if fe is not None
                 else "") + f"): prefill {times['prefill_ms']:.1f} ms, "
              f"decode {times['decode_ms_per_token']:.2f} ms/token (cold)")
        out["models"][arch] = rec
        del model, params, prompt, fe
        torch.cuda.empty_cache()


def family_launches(cfg) -> tuple[dict, int]:
    """The kernel launches one prefill of a hybrid or encdec model makes,
    by kernel, and how many of its flash_attention launches are
    non-causal: zamba2 runs selective_scan once a Mamba2 layer and the
    shared attention block (causal) once a group; seamless runs
    flash_attention for the encoder's self-attention (non-causal), the
    decoder's (causal) and the cross-attention (non-causal)."""
    if cfg.family == "hybrid":
        return {"selective_scan": cfg.num_layers,
                "flash_attention": cfg.num_layers // cfg.ssm.attn_every}, 0
    return ({"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers},
            cfg.encoder_layers + cfg.num_layers)


def run_lm_families(dev, out: dict) -> None:
    """Phase 8, the hybrid and encdec families (LM_FAMILIES) at full width
    and depth in bf16 (random weights from a seed), each alone on the
    card: generate with family_launches' launches (seamless on LM_PROMPT
    frames), a decode step launching none, the path's kernels against
    their plain versions on the real inputs (zamba2: selective_scan at
    N = 64 and the shared block's causal flash_attention at D = 64;
    seamless: non-causal flash_attention at D = 64), and prefill against
    decode in bf16 and in f32 (zamba2 at LM_HYBRID_F32_LAYERS layers,
    seamless at full depth on LM_ENC_FRAMES frames)."""
    from repro_torch import configs
    from repro_torch.launch.serve_llm import frontend_embeds, generate
    from repro_torch.models import build

    for arch in LM_FAMILIES:
        t_model = time.perf_counter()
        cfg = configs.get(arch)
        model = build(cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        t0 = time.perf_counter()
        params = model.init(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                               generator=gen, device=dev)
        prompt = tokens[:, :LM_PROMPT]
        fe = frontend_embeds(cfg, LM_BATCH, LM_PROMPT, gen)
        want, non_causal = family_launches(cfg)
        toks, times, counts, variants, masks = lm_path(
            model, params, prompt, arch, want, fe)
        require(masks["non_causal"] == non_causal,
                f"{arch}: {masks['non_causal']} non-causal flash_attention "
                f"launches in one generate, want {non_causal}")
        decode_launches_nothing(model, params, prompt, arch, fe)
        warm = generate(model, params, prompt, LM_GEN, fe)[1]
        rec = {"layers": cfg.num_layers,
               "encoder_layers": cfg.encoder_layers, "init_s": init_s,
               "launches": counts,
               "flash_attention_variant_launches": variants,
               "flash_attention_mask_launches": masks, "cold": times,
               "warm": warm,
               "frontend_positions": None if fe is None else fe.shape[1],
               "params_b": sum(p.numel() for p in params.parameters()) / 1e9,
               "prefill_tokens_per_s": LM_BATCH * LM_PROMPT
               / (warm["prefill_ms"] / 1e3),
               "decode_tokens_per_s": LM_BATCH
               / (warm["decode_ms_per_token"] / 1e3),
               "tokens_row0": toks[0].tolist()}
        print(f"[lm] {arch} ({cfg.num_layers} layers"
              + (f" + {cfg.encoder_layers} encoder layers on "
                 f"{fe.shape[1]} frames" if fe is not None else "")
              + f"): {rec['params_b']:.2f} B parameters (init {init_s:.1f} "
              f"s); prefill {warm['prefill_ms']:.1f} ms for "
              f"{LM_BATCH}x{LM_PROMPT} ({rec['prefill_tokens_per_s']:.0f} "
              f"tokens/s), decode {warm['decode_ms_per_token']:.2f} "
              f"ms/token ({rec['decode_tokens_per_s']:.1f} tokens/s at batch "
              f"{LM_BATCH}); cold prefill {times['prefill_ms']:.1f} ms")
        kern = out["kernels"]
        if cfg.family == "hybrid":
            n64 = check_scan(params, cfg, tokens)
            n64["launches"] = counts["selective_scan"]
            kern["selective_scan"]["n64"] = {arch: n64}
            d64 = check_flash(params, cfg, tokens)
        else:
            d64 = check_flash_noncausal(params, cfg, tokens, fe)
        d64["launches"] = counts["flash_attention"]
        d64["non_causal_launches"] = masks["non_causal"]
        kern["flash_attention"].setdefault("d64", {})[arch] = d64
        e = prefill_vs_decode(model, params, tokens, fe)
        rec["prefill_vs_decode_bf16"] = e
        require(e <= TOL_LM["pvd_bf16"], f"{arch}: bf16 prefill against "
                f"decode {e:.3e} > {TOL_LM['pvd_bf16']}")
        del model, params, tokens, prompt, fe, toks
        torch.cuda.empty_cache()

        layers = (LM_HYBRID_F32_LAYERS if cfg.family == "hybrid"
                  else cfg.num_layers)
        cfg32 = cfg.scaled(num_layers=layers, dtype="float32")
        model = build(cfg32, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED + 9))
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                               generator=gen, device=dev)
        fe = frontend_embeds(cfg, LM_BATCH, LM_ENC_FRAMES, gen)
        e = prefill_vs_decode(model, params, tokens, fe)
        rec["prefill_vs_decode_f32"] = e
        where = (f"{layers} layers" if fe is None else
                 f"{fe.shape[1]} frames against {LM_PROMPT + 1} tokens")
        rec["prefill_vs_decode_f32_at"] = where
        require(e <= TOL_LM["pvd_f32"], f"{arch}: f32 prefill against "
                f"decode ({where}) {e:.3e} > {TOL_LM['pvd_f32']}")
        print(f"[lm] {arch}: prefill against decode, last-position logits: "
              f"bf16 {rec['prefill_vs_decode_bf16']:.3e} (limit "
              f"{TOL_LM['pvd_bf16']}), f32 at {where} {e:.3e} (limit "
              f"{TOL_LM['pvd_f32']})")
        rec["s"] = time.perf_counter() - t_model
        out["models"][arch] = rec
        del model, params, tokens, fe
        torch.cuda.empty_cache()


# -- phase 10: the planner ----------------------------------------------------

# quad/gra on A three ways: bf16 forced at bf16's guard, "auto" at a
# loose and at a tight tolerance.  The reference's bound: the low-precision
# answer within 100 x tol of the f32 one (tests/test_precision.py).
PLAN_ITERS = 200
PLAN_TOL = {"bf16": 1e-5, "auto_loose": 1e-4, "auto_tight": 1e-9}
LLAMA_ATTN = {"bh": LM_BATCH * 24, "bkv": LM_BATCH * 8, "sq": LM_PROMPT,
              "sk": LM_PROMPT, "d": 128, "causal": 1}
MLA_ATTN = {"bh": LM_BATCH * 128, "bkv": LM_BATCH * 128, "sq": LM_PROMPT,
            "sk": LM_PROMPT, "d": 192, "causal": 1}
MAMBA_SCAN = {"bt": LM_BATCH, "s": LM_PROMPT, "d": 8192, "n": 16}
ZAMBA_ATTN = {"bh": LM_BATCH * 32, "bkv": LM_BATCH * 32, "sq": LM_PROMPT,
              "sk": LM_PROMPT, "d": 64, "causal": 1}
ZAMBA_SCAN = {"bt": LM_BATCH, "s": LM_PROMPT, "d": 4096, "n": 64}
SEAMLESS_ATTN = {"bh": LM_BATCH * 16, "bkv": LM_BATCH * 16, "sq": LM_PROMPT,
                 "sk": LM_PROMPT, "d": 64, "causal": 0}


def planner_shapes() -> list:
    """(kernel, dims, dtype) of the launches the script's paths make, for
    the check that tune="auto" resolves to today's launch."""
    f32, bf16 = "float32", "bfloat16"
    S = {"m": M_S, "n": N_S, "bs": BS_S, "ell": ELL_S}
    SIM = {"m": M_SIM, "n": N_SIM, "bs": BS_S, "ell": ELL_S}
    out = []
    for dt in (f32, bf16):
        out += [("gemm", {"m": M, "k": N, "n": K_GEMM}, dt),
                ("gemm", {"m": M_W, "k": N_W, "n": R_SKETCH}, dt),
                ("tsgram", {"m": M, "n": N}, dt),
                ("randsketch", {"m": M_W, "n": N_W, "r": R_SKETCH}, dt),
                ("fused_grad", {"m": M, "n": N}, dt),
                ("fused_grad", {"m": M_W, "n": N_W}, dt),
                ("fused_grad_multi", {"m": M, "n": N}, dt),
                ("fused_grad_bsr", S, dt), ("fused_grad_bsr_multi", S, dt)]
    out += [("gemm", {"m": M, "k": N - 1, "n": K_GEMM}, f32),
            ("gemm", {"m": M_W, "k": R_SKETCH, "n": R_SKETCH}, f32),
            ("gemm", {"m": M, "k": N, "n": K_SVD}, f32),
            ("gemm", {"m": N_BLOCK, "k": N_BLOCK, "n": N_BLOCK}, f32),
            ("tsgram", {"m": M, "n": N - 1}, f32),
            ("tsgram", {"m": M_SIM, "n": N_SIM}, f32),
            ("randsketch", {"m": M_W, "n": N_W - 1, "r": R_SKETCH}, f32),
            ("fused_grad", {"m": M_LIN, "n": N}, f32),
            ("fused_grad", {"m": 10000, "n": 1024}, f32),
            ("fused_grad", {"m": 10000, "n": 250}, f32),
            ("fused_grad_multi", {"m": M_LIN, "n": N}, f32),
            ("bsr_rmatmul", dict(S, nx=512), f32),
            ("bsr_rmatmul", dict(SIM, nx=512), f32),
            ("flash_attention", LLAMA_ATTN, bf16),
            ("flash_attention", MLA_ATTN, bf16),
            ("flash_attention", ZAMBA_ATTN, bf16),
            ("flash_attention", SEAMLESS_ATTN, bf16),
            ("flash_attention", dict(SEAMLESS_ATTN, causal=1), bf16),
            ("selective_scan", MAMBA_SCAN, f32),
            ("selective_scan", ZAMBA_SCAN, f32)]
    # Phase 13's e4m3 launches: rows 1-4 on A, its ragged view, U.
    e4m3 = "float8_e4m3fn"
    out += [("gemm", {"m": M, "k": N, "n": K_GEMM}, e4m3),
            ("gemm", {"m": M, "k": N - 1, "n": K_GEMM}, e4m3),
            ("tsgram", {"m": M, "n": N}, e4m3),
            ("tsgram", {"m": M, "n": N - 1}, e4m3),
            ("fused_grad", {"m": M, "n": N}, e4m3),
            ("fused_grad_multi", {"m": M, "n": N}, e4m3)]
    for dt in (f32, bf16, "int8"):
        out.append(("bsr_matvec", dict(S, nx=1), dt))
        for nx in (1, 8, 16):
            out += [("bsr_matmul", dict(S, nx=nx), dt),
                    ("bsr_rmatmul", dict(S, nx=nx), dt)]
    return out


def todays_launch(kernel: str, d: dict) -> dict:
    """The launch choice each wrapper made before the autotuner: what
    tune="auto" must resolve to with no sweep and no calibration.  gemm's
    tile width is gemm.tile_width's; every other kernel has one launch,
    its wrapper's own rule, and no choice to resolve."""
    from repro_torch.kernels import gemm
    return {"bn": gemm.tile_width(d["n"])} if kernel == "gemm" else {}


def check_resolves() -> list:
    """tune="auto" with an empty cache and the built-in model resolves to
    today's launch at every shape of planner_shapes()."""
    from repro_torch.kernels import autotune as at

    rows = []
    for kernel, d, dtype in planner_shapes():
        got = at.resolve(kernel, d, dtype, {}, tune="auto", backend="cuda")
        want = todays_launch(kernel, d)
        require(got == want,
                f"{kernel} {d} {dtype}: tune='auto' resolves to {got}, "
                f"today's launch is {want}")
        rows.append(f"{kernel}{[d.get(k) for k in at.KERNELS[kernel].dims]}"
                    f"/{dtype}: {want or 'one launch'}")
    print(f"[planner] tune='auto' = today's launch at {len(rows)} shapes: "
          + "; ".join(rows))
    return rows


def row_dims(row) -> tuple[dict, str]:
    """The planner's dims and dtype of a kernel row (its PERF.md §6 shape)."""
    S = {"m": M_S, "n": N_S, "bs": BS_S, "ell": ELL_S}
    return {"fused_grad": ({"m": M, "n": N}, "float32"),
            "tsgram": ({"m": M, "n": N}, "float32"),
            "gemm": ({"m": M, "k": N, "n": K_GEMM}, "float32"),
            "fused_grad_multi": ({"m": M, "n": N, "k": SLOTS}, "float32"),
            "randsketch": ({"m": M_W, "n": N_W, "r": R_SKETCH}, "float32"),
            "bsr_matvec": (dict(S, nx=1), "float32"),
            "bsr_matmul": (dict(S, nx=K_U), "float32"),
            "bsr_rmatmul": (dict(S, nx=1), "float32"),
            "fused_grad_bsr": (S, "float32"),
            "fused_grad_bsr_multi": (dict(S, k=SLOTS), "float32"),
            "flash_attention": (LLAMA_ATTN, "bfloat16"),
            "selective_scan": (MAMBA_SCAN, "float32")}[row["name"]]


def check_model_bounds(rows) -> dict:
    """At efficiency 1 the built-in model's time of each kernel row is its
    bound within 1% (the bound's bytes and flops on the kernel's route)."""
    from repro_torch.kernels import autotune as at

    out = {}
    for row in rows:
        d, dtype = row_dims(row)
        model_ms = at.model_time(row["name"], at.legacy(row["name"], d, dtype),
                                 d, dtype, machine=_machine.H100) * 1e3
        out[row["name"]] = {"model_ms": model_ms, "bound_ms": row["bound_ms"]}
        require(abs(model_ms - row["bound_ms"]) <= 0.01 * row["bound_ms"],
                f"{row['name']}: modeled {model_ms:.4f} ms at efficiency 1, "
                f"bound {row['bound_ms']:.4f} ms")
    print("[planner] model at efficiency 1 against the bound: " + ", ".join(
        f"{k} {v['model_ms']:.3f}/{v['bound_ms']:.3f} ms"
        for k, v in out.items()))
    return out


def planner_decisions(S) -> dict:
    """The plans phase 10 prints, before and after calibration."""
    from repro_torch.launch import planner

    A = {"m": M, "n": N}
    plans = {
        "grad": planner.plan("grad", A, backend="cuda"),
        "grad tol 1e-4": planner.plan("grad", A, backend="cuda",
                                      context={"tol": 1e-4}),
        "gram": planner.plan("gram", A, backend="cuda"),
        # e4m3 storage, each priced on the route its kernel runs: the
        # fused pass's f32 FMAs, tsgram's 16-bit mma.sync, gemm's TF32.
        "grad e4m3": planner.plan("grad", A, "float8_e4m3fn",
                                  backend="cuda"),
        "gram e4m3": planner.plan("gram", A, "float8_e4m3fn",
                                  backend="cuda"),
        "gemm e4m3": planner.plan("gemm", {"m": M, "k": N, "n": K_GEMM},
                                  "float8_e4m3fn", backend="cuda"),
        "svd A": planner.plan("svd", {"m": M, "n": N, "k": K_SVD},
                              backend="cuda", context={"kind": "row"}),
        "svd A_w": planner.plan("svd", {"m": M_W, "n": N_W, "k": K_SVD},
                                backend="cuda", context={"kind": "row"}),
        "svd S": planner.plan("svd", {"m": M_S, "n": N_S, "k": K_SVD},
                              backend="cuda",
                              context={"kind": "sparse",
                                       "nnz": M_S * ELL_S * BS_S})}
    sdims = {"m": S.m_pad, "n": S.n_pad, "ell": S.ell, "bs": S.bs, "nx": 1}
    plans["sparse_matmul S"] = planner.plan("sparse_matmul", sdims,
                                            backend="cuda")
    plans["sparse_matmul S tol 1e-3"] = planner.plan(
        "sparse_matmul", sdims, backend="cuda", context={"tol": 1e-3})
    plans["bsr_bs S"] = planner.plan(
        "bsr_bs", {"m": M_S, "n": N_S, "nx": 1}, backend="cuda",
        context={"ell_by_bs": ell_by_bs(S)})
    return plans


def ell_by_bs(S) -> dict:
    """S's ELL width at each candidate block size: its 32 x 32 blocks are
    dense (Gaussian), so a finer block size splits each into (32/bs)^2
    stored blocks, and a coarser one merges the distinct block columns of
    each run of block-rows."""
    out = {}
    nbr, nbc = S.cols.shape[0], S.n_pad // S.bs
    for bs in (8, 16, 32, 64, 128):
        if bs <= S.bs:
            out[bs] = S.ell * (S.bs // bs)
            continue
        f = bs // S.bs
        rows = torch.arange(nbr, device=S.device)[:, None] // f
        key = torch.unique(rows * (nbc // f) + S.cols.long() // f)
        out[bs] = int(torch.bincount(key // (nbc // f)).max())
    return out


def sweep_gemm(dev, A, A_w) -> dict:
    """gemm's output-tile sweep at A x 16 and A_w x 26: every candidate
    held to TOL["gemm"] against plain with one launch a call, timed with
    CUDA events; the winner recorded into the (temporary) autotune cache,
    and the next resolve a memo hit."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import gemm

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    out = {}
    for key, a, n in (("A", A, K_GEMM), ("A_w", A_w, R_SKETCH)):
        b = torch.randn(a.shape[1], n, generator=gen, device=dev)
        want = gemm.gemm_plain(a, b, torch.float32)
        dims = {"m": a.shape[0], "k": a.shape[1], "n": n}
        errs = {}

        def run(choice):
            got = one_launch(gemm.gemm, lambda: gemm.gemm(
                a, b, out_dtype=torch.float32, bn=choice["bn"]),
                f"gemm sweep {key} {choice}")
            errs[choice["bn"]] = rel_err(got, want)
            return time_ms(lambda: gemm.gemm(
                a, b, out_dtype=torch.float32, bn=choice["bn"]),
                reps=5) * 1e-3

        timed = at.sweep("gemm", dims, "float32", run, top_n=3, reps=1)
        for bn, e in errs.items():
            require(e <= TOL["gemm"], f"gemm sweep {key} bn={bn}: relative "
                    f"error {e:.3e} > {TOL['gemm']}")
        best_s, best = timed[0]
        at.record("gemm", dims, "float32", best, backend="cuda",
                  us=best_s * 1e6)
        hits = at.stats["memo_hits"]
        again = at.resolve("gemm", dims, "float32", {}, backend="cuda")
        require(at.stats["memo_hits"] == hits + 1 and again["bn"] ==
                best["bn"], f"gemm sweep {key}: the resolve after record "
                "missed the memo")
        out[key] = {"shape": [a.shape[0], a.shape[1], n],
                    "ms": {str(c["bn"]): s * 1e3 for s, c in timed},
                    "rel_err": {str(k): v for k, v in errs.items()},
                    "winner": best, "legacy": at.legacy("gemm", dims,
                                                        "float32")}
        print(f"[planner] gemm sweep at {out[key]['shape']}: "
              + ", ".join(f"bn={c['bn']} {s * 1e3:.3f} ms" for s, c in timed)
              + f"; recorded bn={best['bn']} (today's "
              f"{out[key]['legacy']['bn']})")
        del b, want
    return out


def precision_solves(api, ops, A, L0) -> dict:
    """quad/gra on A three ways (see PLAN_TOL), each held to its bound;
    bf16's fused_grad launches checked to run on a bf16 A."""
    from repro_torch.core.distmat import RowMatrix

    dev = A.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    x_true = torch.randn(N, generator=gen, device=dev)
    b = A @ x_true + 0.5 * torch.randn(M, generator=gen, device=dev)
    rm = RowMatrix.create(A, device=dev)
    seen = []
    plain_fused_grad = ops.fused_grad

    def spy(a, *args, **kw):
        seen.append(a.dtype)
        return plain_fused_grad(a, *args, **kw)

    def solve(precision, tol):
        seen.clear()
        before = ops.launch_counts()["fused_grad"]
        ops.fused_grad = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = api.solve(api.SolveRequest(
                A=rm, b=b, loss="quad", method="gra", L0=L0, tol=tol,
                max_iters=PLAN_ITERS, precision=precision, device=dev))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.fused_grad = plain_fused_grad
        info = res.info
        rec = {"precision": info["precision"], "tol": tol,
               "iterations": info["iterations"],
               "a_passes": info["a_passes"],
               "fused_grad_launches": ops.launch_counts()["fused_grad"]
               - before, "storage": sorted({str(t) for t in seen}),
               "ms": ms, "ms_per_iteration": ms / max(info["iterations"], 1),
               "objective64": quad_objective64(A, b, res.x)}
        require(rec["fused_grad_launches"] == info["a_passes"],
                f"precision {precision}: {rec['fused_grad_launches']} "
                f"fused_grad launches != {info['a_passes']} A-passes")
        return rec

    out = {"f32": solve("f32", PLAN_TOL["bf16"]),
           "bf16": solve("bf16", PLAN_TOL["bf16"]),
           "auto_loose": solve("auto", PLAN_TOL["auto_loose"]),
           "auto_tight": solve("auto", PLAN_TOL["auto_tight"])}
    bf, f32 = out["bf16"], out["f32"]
    gap = abs(bf["objective64"] - f32["objective64"]) / abs(f32["objective64"])
    bf["objective_rel_to_f32"] = gap
    require(bf["precision"] == "bf16" and bf["storage"] == ["torch.bfloat16"],
            f"precision bf16: ran {bf['precision']} on {bf['storage']}")
    require(f32["storage"] == ["torch.float32"], "precision f32: storage "
            f"{f32['storage']}")
    require(gap <= 100 * PLAN_TOL["bf16"], f"precision bf16: objective "
            f"{gap:.3e} from f32's, over 100 x {PLAN_TOL['bf16']}")
    require(out["auto_tight"]["precision"] == "f32",
            f"precision auto at tol {PLAN_TOL['auto_tight']}: "
            f"{out['auto_tight']['precision']}")
    for key, r in out.items():
        print(f"[planner] quad/gra {key}: ran {r['precision']} on "
              f"{r['storage']}, tol {r['tol']:g}, {r['iterations']} "
              f"iterations, {r['a_passes']} A-passes, "
              f"{r['ms_per_iteration']:.3f} ms/iteration, float64 objective "
              f"{r['objective64']:.9e}")
    print(f"[planner] bf16 objective {gap:.3e} from f32's (limit "
          f"{100 * PLAN_TOL['bf16']:g})")
    del rm, b
    return out


def budget_serve(api, A, L0) -> dict:
    """Phase 5's solve requests once more, through a SolverServer whose
    budget is twice one group's modeled pass: three groups, so the third
    waits for one to drain; every request must finish."""
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.launch import planner
    from repro_torch.launch.serve import SolverServer

    dev = A.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    X = torch.randn(32, N, generator=gen, device=dev)
    Z = (A @ X.T).T
    B_quad = Z[:24] + 0.05 * torch.randn(24, M, generator=gen, device=dev)
    B_log = torch.where(Z[24:] + torch.randn(8, M, generator=gen, device=dev)
                        > 0, 1.0, -1.0)
    del Z
    rm = RowMatrix.create(A, device=dev)
    cost = planner.plan("fused_grad", {"m": M, "n": N}, backend="cuda").cost_s
    server = SolverServer(slots=SLOTS, budget_s=2 * cost, backend="cuda")
    reqs = serve_requests(api, rm, B_quad, B_log, L0, lambda i: True)
    ids = [server.submit(r) for r in reqs]
    t0 = time.perf_counter()
    server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = [server.result(i) for i in ids]
    require(all(r is not None for r in done) and not server.busy(),
            "budgeted server: a request did not finish")
    stats = server.stats
    rec = {"budget_s": 2 * cost, "group_pass_model_s": cost,
           "requests": len(ids), "steps": stats["steps"],
           "admitted": stats["admitted"],
           "deferred_steps": stats["deferred_steps"],
           "a_passes": stats["a_passes"], "wall_s": wall}
    print(f"[planner] budgeted server (budget {2 * cost * 1e6:.1f} us, "
          f"two group passes): {len(ids)} requests, {stats['steps']} steps, "
          f"{stats['admitted']} admissions, {stats['deferred_steps']} "
          f"deferred steps, {stats['a_passes']} group A-passes, "
          f"{wall:.2f} s")
    del rm, B_quad, B_log
    return rec


def calibration_inputs(kernels, lm_kernels) -> list:
    """(kernel, dims, dtype, measured s) from the kernel medians phases 2,
    5, 6 and 8 took, at the shapes they took them."""
    S = {"m": M_S, "n": N_S, "bs": BS_S, "ell": ELL_S}
    dn = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}
    out = []
    for dt in ("f32", "bf16"):
        k = kernels
        out += [("fused_grad", {"m": M, "n": N}, dn[dt],
                 k["fused_grad"][dt]["quad"]["ms"]),
                ("fused_grad", {"m": M_W, "n": N_W}, dn[dt],
                 k["fused_grad"]["wide"][dt]["ms"]),
                ("tsgram", {"m": M, "n": N}, dn[dt], k["tsgram"][dt]["ms"]),
                ("gemm", {"m": M, "k": N, "n": K_GEMM}, dn[dt],
                 k["gemm"][dt]["ms"]),
                ("randsketch", {"m": M_W, "n": N_W, "r": R_SKETCH}, dn[dt],
                 k["randsketch"][dt]["ms"]),
                ("fused_grad_bsr", S, dn[dt],
                 k["fused_grad_bsr"][dt]["quad"]["ms"])]
        out += [("fused_grad_multi", {"m": M, "n": N, "k": km}, dn[dt],
                 r["ms"]) for km, r in k["fused_grad_multi"][dt].items()]
        out += [("fused_grad_bsr_multi", dict(S, k=km), dn[dt], r["ms"])
                for km, r in k["fused_grad_bsr_multi"][dt].items()]
    out += [("gemm", {"m": M_W, "k": N_W, "n": R_SKETCH}, "float32",
             kernels["gemm"]["wide"]["A_w"]["ms"]),
            ("gemm", {"m": M_W, "k": R_SKETCH, "n": R_SKETCH}, "float32",
             kernels["gemm"]["wide"]["tsqr"]["ms"])]
    for dt in ("f32", "bf16", "int8"):
        out += [("bsr_matvec", dict(S, nx=1), dn[dt],
                 kernels["bsr_matvec"][dt]["ms"]),
                ("bsr_matmul", dict(S, nx=K_U), dn[dt],
                 kernels["bsr_matmul"][dt]["ms"]),
                ("bsr_rmatmul", dict(S, nx=1), dn[dt],
                 kernels["bsr_rmatmul"][dt]["ms"]),
                ("bsr_rmatmul", dict(S, nx=K_U), dn[dt],
                 kernels["bsr_rmatmul"][f"{dt}_nx{K_U}"]["ms"])]
    out += [("flash_attention", LLAMA_ATTN, "bfloat16",
             lm_kernels["flash_attention"]["bf16"]["ms"]),
            ("selective_scan", MAMBA_SCAN, "float32",
             lm_kernels["selective_scan"]["f32"]["ms"])]
    return [(kn, d, dt, ms * 1e-3) for kn, d, dt, ms in out]


def run_calibration(kernels, lm_kernels, before_plans, S) -> dict:
    """calibrate() over records of the script's kernel medians; the fitted
    efficiencies, error() before and after (after must be no larger) and
    every printed decision that flips under the calibrated model."""
    from repro_torch.kernels import autotune as at
    from repro_torch.launch import planner

    records = []
    for kernel, d, dtype, secs in calibration_inputs(kernels, lm_kernels):
        records.append(planner.calibration_record(
            kernel, d, at.legacy(kernel, d, dtype), dtype, secs))
    fitted, err0, err1 = planner.calibrate(records, backend="cuda")
    require(err1 <= err0, f"calibration: error {err0:.4f} -> {err1:.4f}")
    effs = {dt: {"mxu_eff": fitted.mxu_eff.get(dt),
                 "hbm_eff": fitted.hbm_eff.get(dt)}
            for dt in sorted({r["dtype"] for r in records})}
    after = planner_decisions(S)
    flips = {k: [before_plans[k].choice + (f"/{before_plans[k].precision}"
                                            if before_plans[k].precision
                                            else ""),
                 p.choice + (f"/{p.precision}" if p.precision else "")]
             for k, p in after.items()
             if (p.choice, p.precision, dict(p.blocks)) !=
             (before_plans[k].choice, before_plans[k].precision,
              dict(before_plans[k].blocks))}
    print(f"[planner] calibrate(): {len(records)} records, mean relative "
          f"error {err0:.4f} -> {err1:.4f}, step_overhead_s "
          f"{fitted.step_overhead_s:.3e}; "
          + "; ".join(f"{dt} mxu_eff {e['mxu_eff']} hbm_eff {e['hbm_eff']}"
                      for dt, e in effs.items()))
    print(f"[planner] decisions that flip under the calibrated model: "
          f"{flips or 'none'}")
    for key in flips:
        print(f"[planner] calibrated {key}:\n{after[key].explain()}")
    return {"records": len(records), "error_before": err0,
            "error_after": err1, "efficiencies": effs,
            "step_overhead_s": fitted.step_overhead_s, "flips": flips,
            "calibrated_costs_ms": {k: p.cost_s * 1e3
                                    for k, p in after.items()}}


def run_phase10(api, ops, dev, rows, kernels, lm_kernels, L0) -> dict:
    """Phase 10: the planner on the card (see the module docstring)."""
    from repro_torch.kernels import bsr

    t10 = time.perf_counter()
    rec = {"resolves": len(check_resolves()),
           "model_vs_bound": check_model_bounds(rows)}
    # The sparse decisions on S, made again from its seed.
    S = sparse_matrix(dev)
    before = planner_decisions(S)
    for key, p in before.items():
        print(f"[planner] {key}:\n{p.explain()}")
    quant = bsr.auto_quantize(S.m_pad, S.n_pad, S.ell, S.bs, 1e-3, "cuda")
    use_bsr = S._use_bsr(1, "auto")
    ops.reset_launch_counts()
    y = S.matvec(torch.ones(N_S, device=dev))
    torch.cuda.synchronize()
    launched = ops.launch_counts()["bsr_matvec"]
    require(quant == "int8", f"quantize='auto' on S at tol 1e-3: {quant}")
    require(use_bsr and launched == 1 and bool(torch.isfinite(y).all()),
            f"dispatch='auto' on S: bsr {use_bsr}, {launched} bsr_matvec "
            "launches")
    rec["sparse"] = {"quantize_auto_tol_1e-3": quant,
                     "dispatch_auto": "bsr" if use_bsr else "dense",
                     "ell_by_bs": ell_by_bs(S)}
    print(f"[planner] S: quantize='auto' at tol 1e-3 -> {quant}; "
          f"dispatch='auto' -> {rec['sparse']['dispatch_auto']} "
          f"({launched} bsr_matvec launch)")
    del y
    torch.cuda.empty_cache()
    # A and A_w made again from their seeds, as phases 2-5 made them.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = 1.0 + 2.0 * 0.95 ** torch.arange(N, device=dev, dtype=torch.float32)
    A = torch.randn(M, N, generator=gen, device=dev)
    A.mul_(d / math.sqrt(N))
    A_w = wide_matrix(dev, torch.Generator(device=dev).manual_seed(SEED + 1))
    rec["gemm_sweep"] = sweep_gemm(dev, A, A_w)
    del A_w
    torch.cuda.empty_cache()
    rec["solves"] = precision_solves(api, ops, A, L0)
    rec["budget_serve"] = budget_serve(api, A, L0)
    del A
    torch.cuda.empty_cache()
    rec["calibration"] = run_calibration(kernels, lm_kernels, before, S)
    rec["decisions"] = {k: {"choice": p.choice, "precision": p.precision,
                            "blocks": dict(p.blocks),
                            "modeled_ms": p.cost_s * 1e3}
                        for k, p in before.items()}
    del S
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t10
    print(f"[planner] phase 10 in {rec['phase_s']:.1f} s")
    return rec


# -- phase 11: the cluster path -----------------------------------------------
# Phase 3's A and phase 6's S, their rows split over the ranks of a
# torch.distributed group (launch/mesh.spawn, one process a rank): with
# one card a one-rank NCCL group and a two-rank gloo group whose ranks
# share the card (NCCL takes one rank a card), with more cards NCCL, one
# rank a card.  Every rank draws the whole matrix from its seed and keeps
# its strip; the multi-rank group is held to the one-rank group.
CLUSTER_CHUNKS = 4             # the chunked Gram's column segments
# The strips' low-precision copies whose chunked Gram and chunked fused
# gradient (randsketch launches on the strip's segments) run against
# their eager bodies on the same strips.
CLUSTER_LOW = (("bf16", torch.bfloat16), ("e4m3", torch.float8_e4m3fn),
               ("e5m2", torch.float8_e5m2))
# Iteration caps of the cluster solves, run at tol 0 so every run takes
# them all and the A-pass counts compare exactly: quad/gra and quad/acc_rb
# on A, the psum8 pair (gra at PSUM8_TOL against its f32 twin) and
# quad/gra fused on S.  acc_rb backtracks: 15 iterations keep its
# backtracking tests off the f32 rounding floor, where they fall either
# way (ROADMAP queue 3); at 60 the one- and two-rank runs took 11 and 29
# backtracks on the CPU at a small size.
CLUSTER_ITERS = {"gra": 100, "acc_rb": 15, "psum8": 200, "sparse": 30}
CLUSTER_SLOTS = 8              # fused_grad_multi's right-hand sides
PSUM8_TOL = 1e-5               # tests/test_precision.py's solve tolerance
CLUSTER_POWER_ITERS = 20       # S's L0: power iterations on SᵀS, x 1.5
CLUSTER_TIMEOUT_S = 120        # each process group's collective timeout
# Normwise relative limits, the multi-rank group against the one-rank:
# another order of summation for g, the Gram and the solves' objectives.
CLUSTER_TOL = {"f": TOL["f"], "g": TOL["g"], "z": TOL["z"],
               "gram": TOL["tsgram"], "sigma": 1e-4, "r": 1e-4,
               "objective": 1e-5, "orthogonality": 1e-3}
# all_reduce payloads timed: the fused pass's (g, f), the Gram, psum8's
# int8 gradient.
ALLREDUCE_PAYLOADS = (("fused_grad (g, f) f32", N + 1, torch.float32),
                      ("gram f32", N * N, torch.float32),
                      ("psum8 g int8", N, torch.int8))
ALLREDUCE_REPS = 20
# The served groups on A's and S's strips (CLUSTER_SLOTS quad requests a
# group, b scaled 1 + 0.1 j, every rank submitting the same), at tol 0 so
# every request runs its cap and the A-passes compare exactly; the caps
# keep the backtracking tests (gra, acc_rb) off the f32 rounding floor as
# CLUSTER_ITERS does (on the CPU at 4096 x 64 the acc_rb group took 20
# passes on one rank and 21 on two at 15 iterations, 12 and 12 at 8).
# Then an accelerated (acc) ElasticGroup on A through a seeded device
# loss: shard 1 lost at iteration 3, the survivors re-meshed (on one rank
# the same rank), AX and AZ zeroed and re-seeded.
CLUSTER_SERVE_ITERS = {"gra": 10, "acc": 30, "acc_rb": 8, "sparse": 15}
CLUSTER_LOSS = dict(lose_shard_at=3, lost_shard=1)
CLUSTER_ELASTIC_ITERS = 20
# The served and elastic answers against the one-rank group's: phase 11's
# objective limit, x normwise within 1e-4 (phase 12's serving limit is
# 1e-5 for the same path on one rank).
CLUSTER_SERVE_TOL = {"objective": 1e-5, "x": 1e-4}


def _cluster_serve(api, ops, A, bs, method, iters, L0, kernel, dev) -> dict:
    """One SolverServer group of len(bs) quad requests on A at tol 0 (each
    runs `iters` iterations): each answer's objective and x, the server's
    group A-passes, the launches of `kernel` it made and its wall ms."""
    from repro_torch.launch.serve import SolverServer

    torch.cuda.synchronize(dev)
    before = ops.launch_counts()[kernel]
    t0 = time.perf_counter()
    srv = SolverServer(slots=len(bs))
    ids = [srv.submit(api.SolveRequest(A=A, b=b, method=method, tol=0.0,
                                       max_iters=iters, L0=L0, device=dev))
           for b in bs]
    srv.run()
    torch.cuda.synchronize(dev)
    res = [srv.result(i) for i in ids]
    return {"ms": (time.perf_counter() - t0) * 1e3,
            "objective": [float(r.info["objective"]) for r in res],
            "iterations": [int(r.info["iterations"]) for r in res],
            "a_passes": srv.stats["a_passes"],
            "launches": ops.launch_counts()[kernel] - before,
            "x": torch.stack([r.x for r in res]).cpu()}


def _cluster_elastic(ops, rm, b, L0, dev) -> dict:
    """solve_elastic's acc group on `rm` at tol 0 through CLUSTER_LOSS's
    device loss (FaultyMesh over rm's mesh): x, objective, A-passes, the
    fused_grad_multi launches, the re-mesh's ms and the casualties."""
    from repro_torch.core.optim.elastic import ElasticConfig, solve_elastic
    from repro_torch.core.tfocs.linop import LinopMatrix
    from repro_torch.launch import telemetry as tel
    from repro_torch.train.faults import FaultPlan, FaultyLinop, FaultyMesh

    fm = FaultyMesh(rm.mesh)
    lin = FaultyLinop(LinopMatrix(rm), FaultPlan(**CLUSTER_LOSS),
                      sleep=_nosleep)
    torch.cuda.synchronize(dev)
    before = ops.launch_counts()["fused_grad_multi"]
    t0 = time.perf_counter()
    with tel.recording() as spans:
        x, info = solve_elastic(lin, "quad", b, method="acc", tol=0.0,
                                max_iters=CLUSTER_ELASTIC_ITERS, L0=L0,
                                elastic=ElasticConfig(remesh_to=fm.drop))
        torch.cuda.synchronize(dev)
    return {"ms": (time.perf_counter() - t0) * 1e3, "x": x.cpu(),
            "objective": float(info["objective"]),
            "iterations": int(info["iterations"]),
            "a_passes": int(info["a_passes"]),
            "remeshes": int(info["remeshes"]),
            "dropped": bool(info.get("dropped", False)),
            "casualties": list(fm.casualties),
            "launches": ops.launch_counts()["fused_grad_multi"] - before,
            "remesh_ms": [sp.dur_s * 1e3 for sp in spans.spans
                          if sp.name == "solver.remesh"]}


def _allreduce_ms(group, n: int, dtype, dev) -> float:
    """Median host-clock ms of one all_reduce of n elements over `group`
    (synchronized before and after: a collective staged through the host
    is not on the card's event clock)."""
    import torch.distributed as dist
    t = torch.ones(n, dtype=dtype, device=dev)
    times = []
    for i in range(ALLREDUCE_REPS + 2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize(dev)
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _wall_ms(fn, dev, reps: int = 5) -> float:
    """Median host-clock ms of `fn` (synchronized before and after) over
    `reps` calls after one warm call: a body with collectives staged
    through the host is not on the card's event clock."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _cluster_solve(api, ops, A, b, method, iters, L0, kernel, dev,
                   **kw) -> dict:
    """One api.solve on a sharded matrix at tol 0 (it runs all `iters`):
    its objective, A-passes, x and the launches of `kernel` it made."""
    before = ops.launch_counts()[kernel]
    res = api.solve(api.SolveRequest(A=A, b=b, method=method, tol=0.0,
                                     max_iters=iters, L0=L0, device=dev,
                                     **kw))
    torch.cuda.synchronize(dev)
    return {"objective": float(res.info["objective"]),
            "a_passes": int(res.info["a_passes"]),
            "iterations": int(res.info["iterations"]),
            "precision": res.info["precision"], "plan": res.info["plan"],
            "launches": ops.launch_counts()[kernel] - before,
            "x": res.x.cpu()}


def cluster_rank(rank: int, L0: float | None, L0_S: float | None) -> dict:
    """Phase 11 on one rank of the group launch/mesh.spawn started: the
    cluster path with the counts zeroed just before and read just after,
    then the all_reduce timings.  `L0` and `L0_S` (the one-rank group's)
    are computed here when None.  Returns this rank's results on the
    CPU."""
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.core.distmat import types as T
    from repro_torch.core.tfocs.smooth import SmoothQuad
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    mesh = T.make_mesh((world, 1), ("data", "model"), device=dev)
    rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "device_name": torch.cuda.get_device_name(dev)}
    # Phase 3's A from its seed, then b and x from their own generator;
    # every rank draws the whole of each and keeps its strip.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = 1.0 + 2.0 * 0.95 ** torch.arange(N, device=dev, dtype=torch.float32)
    A = torch.randn(M, N, generator=gen, device=dev)
    A.mul_(d / math.sqrt(N))
    gen11 = torch.Generator(device=dev).manual_seed(SEED + 11)
    b = A @ torch.randn(N, generator=gen11, device=dev) \
        + 0.5 * torch.randn(M, generator=gen11, device=dev)
    x_fix = 0.1 * torch.randn(N, generator=gen11, device=dev)
    rm = RowMatrix.create(A, mesh=mesh)
    del A
    S_whole = sparse_matrix(dev)
    xs = torch.randn(N_S, generator=gen11, device=dev) / math.sqrt(
        ELL_S * BS_S)
    b_s = S_whole.matvec(xs) + 0.5 * torch.randn(M_S, generator=gen11,
                                                 device=dev)
    S = S_whole.remesh(mesh)
    del S_whole
    torch.cuda.empty_cache()
    # fused_grad_multi's slots (x_fix moved, b rescaled) and the vector
    # of the sparse normal product SᵀS v.
    X_multi = x_fix + 0.01 * torch.randn(CLUSTER_SLOTS, N, generator=gen11,
                                         device=dev)
    quads = [SmoothQuad((1.0 + 0.1 * j) * b) for j in range(CLUSTER_SLOTS)]
    v_s = torch.randn(N_S, generator=gen11, device=dev) / math.sqrt(N_S)
    rec["rows"] = [rm.rows.shape[0], S.data.shape[0] * S.bs]

    # -- the cluster path: counts zeroed just before, read just after -----
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    f, g, z = rm.fused_grad(x_fix, SmoothQuad(b))
    rec["fused_grad"] = {"f": f.cpu(), "g": g.cpu(), "z": z.cpu(),
                         "shard": rm.shard}
    f, g, z = rm.fused_grad_multi(X_multi, quads)
    rec["fused_grad_multi"] = {"f": f.cpu(), "g": g.cpu(), "z": z.cpu()}
    rec["sparse_normal"] = S.rmatvec(S.matvec(v_s)).cpu()
    del f, g, z
    rec["gram"] = rm.gram(chunks=1).cpu()
    rec["gram_chunked"] = rm.gram(chunks=CLUSTER_CHUNKS).cpu()
    # Each rank casts its own strip; chunked against eager on it.
    rec["chunked_low"] = {}
    for tag, dt in CLUSTER_LOW:
        lo = rm.astype_store(dt)
        f1, g1, _ = lo.fused_grad(x_fix, SmoothQuad(b), chunks=1)
        fc, gc, _ = lo.fused_grad(x_fix, SmoothQuad(b), chunks=CLUSTER_CHUNKS)
        rec["chunked_low"][tag] = {
            "gram_rel": rel_err(lo.gram(chunks=CLUSTER_CHUNKS),
                                lo.gram(chunks=1)),
            "f_rel": rel_err(fc, f1), "g_rel": rel_err(gc, g1)}
        del lo, f1, g1, fc, gc
    U, s, _, svd_info = api.compute_svd(rm, K_SVD, mode="gram", device=dev)
    rec["svd"] = {"sigma": s.cpu(), "a_passes": svd_info["a_passes"],
                  "u_orthogonality": float(
                      (U.gram() - torch.eye(K_SVD, device=dev)).abs().max())}
    Q, R = rm.tall_skinny_qr()
    rec["tsqr"] = {"R": R.cpu(), "orthogonality": float(
        (Q.gram() - torch.eye(N, device=dev)).abs().max())}
    del Q, U
    rsvd = api.svd(api.SvdRequest(A=rm, k=K_SVD, mode="randomized",
                                  device=dev))
    rec["randomized"] = {"sigma": rsvd.factors[1].cpu(),
                         "a_passes": rsvd.info["a_passes"]}
    L0 = L0 or float(s[0]) ** 2
    rec["L0"] = L0
    rec["solves"] = {
        method: _cluster_solve(api, ops, rm, b, method,
                               CLUSTER_ITERS[method], L0, "fused_grad", dev,
                               precision="f32")
        for method in ("gra", "acc_rb")}
    for prec in ("f32", "psum8"):
        r = api.solve(api.SolveRequest(
            A=rm, b=b, method="gra", tol=PSUM8_TOL,
            max_iters=CLUSTER_ITERS["psum8"], L0=L0, precision=prec,
            device=dev))
        rec["solves"][f"psum8_{prec}"] = {
            "objective": float(r.info["objective"]),
            "iterations": int(r.info["iterations"]),
            "precision": r.info["precision"], "x": r.x.cpu()}
    if L0_S is None:
        v = torch.ones(N_S, device=dev) / math.sqrt(N_S)
        for _ in range(CLUSTER_POWER_ITERS):
            w = S.rmatvec(S.matvec(v))
            lam = float(torch.linalg.vector_norm(w))
            v = w / lam
        L0_S = 1.5 * lam
    rec["L0_S"] = L0_S
    rec["solves"]["sparse"] = _cluster_solve(
        api, ops, S, b_s, "gra", CLUSTER_ITERS["sparse"], L0_S,
        "fused_grad_bsr", dev, precision="f32")
    # The server over the sharded matrices: fused_grad_multi groups on A,
    # a fused_grad_bsr_multi group on S.
    scale = [1.0 + 0.1 * j for j in range(CLUSTER_SLOTS)]
    rec["served"] = {
        method: _cluster_serve(api, ops, rm, [c * b for c in scale], method,
                               CLUSTER_SERVE_ITERS[method], L0,
                               "fused_grad_multi", dev)
        for method in ("gra", "acc", "acc_rb")}
    rec["served"]["sparse"] = _cluster_serve(
        api, ops, S, [c * b_s for c in scale], "gra",
        CLUSTER_SERVE_ITERS["sparse"], L0_S, "fused_grad_bsr_multi", dev)
    del S, b_s, v_s
    torch.cuda.empty_cache()
    rec["elastic"] = _cluster_elastic(ops, rm, b, L0, dev)
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    rec["path_s"] = time.perf_counter() - t0
    rec["launches"] = ops.launch_counts()
    # -----------------------------------------------------------------------
    group = mesh.group(("data",)) if world > 1 else dist.group.WORLD
    rec["allreduce_ms"] = {name: {"bytes": n * torch.tensor(
        [], dtype=dt).element_size(), "ms": _allreduce_ms(group, n, dt, dev)}
        for name, n, dt in ALLREDUCE_PAYLOADS}
    # The bodies whole, eager against the overlapped schedule and the f32
    # wire against psum8's, on this rank's strip with its collectives.
    quad = SmoothQuad(b)
    res0 = rm.init_psum_residual()
    rec["bodies_ms"] = {
        "gram eager": _wall_ms(lambda: rm.gram(chunks=1), dev),
        f"gram chunks={CLUSTER_CHUNKS}": _wall_ms(
            lambda: rm.gram(chunks=CLUSTER_CHUNKS), dev),
        "fused_grad eager": _wall_ms(lambda: rm.fused_grad(x_fix, quad),
                                     dev),
        f"fused_grad chunks={CLUSTER_CHUNKS}": _wall_ms(
            lambda: rm.fused_grad(x_fix, quad, chunks=CLUSTER_CHUNKS), dev),
        "fused_grad psum8": _wall_ms(
            lambda: rm.fused_grad(x_fix, quad, residual=res0), dev)}
    # The same bodies on each low-precision copy of the strip.
    for tag, dt in CLUSTER_LOW:
        lo = rm.astype_store(dt)
        for c in (1, CLUSTER_CHUNKS):
            how = "eager" if c == 1 else f"chunks={c}"
            rec["bodies_ms"][f"{tag} gram {how}"] = _wall_ms(
                lambda: lo.gram(chunks=c), dev)
            rec["bodies_ms"][f"{tag} fused_grad {how}"] = _wall_ms(
                lambda: lo.fused_grad(x_fix, quad, chunks=c), dev)
        del lo
    return rec


def check_cluster(one: dict, ranks: list) -> dict:
    """The multi-rank group's results against the one-rank group's, and
    each rank's own launch counts."""
    world = len(ranks)
    for r in ranks:
        shard = r["fused_grad"]["shard"]
        for key in ("fused_grad", "fused_grad_multi"):
            got_fg, want_fg = r[key], one[key]
            for part in ("f", "g"):
                e = rel_err(got_fg[part], want_fg[part])
                require(e <= CLUSTER_TOL[part], f"cluster rank {r['rank']} "
                        f"{key}: {part} off by {e:.3e}")
            # This rank's image rows against the same rows of one rank's.
            m_local = got_fg["z"].shape[-1]
            want = want_fg["z"][..., shard * m_local:(shard + 1) * m_local]
            got = got_fg["z"][..., :want.shape[-1]]
            require(rel_err(got, want) <= CLUSTER_TOL["z"],
                    f"cluster rank {r['rank']} {key}: z off by "
                    f"{rel_err(got, want):.3e}")
        e = rel_err(r["sparse_normal"], one["sparse_normal"])
        require(e <= CLUSTER_TOL["g"], f"cluster rank {r['rank']}: SᵀS v "
                f"off by {e:.3e}")
        for key in ("gram", "gram_chunked"):
            e = rel_err(r[key], one["gram"])
            require(e <= CLUSTER_TOL["gram"], f"cluster {key}: {e:.3e}")
        e = rel_err(r["svd"]["sigma"], one["svd"]["sigma"])
        require(e <= CLUSTER_TOL["sigma"], f"cluster Gram SVD sigma {e:.3e}")
        require(r["svd"]["u_orthogonality"] <= CLUSTER_TOL["orthogonality"],
                f"cluster U: |U^T U - I| {r['svd']['u_orthogonality']:.3e}")
        e = rel_err(r["tsqr"]["R"], one["tsqr"]["R"])
        require(e <= CLUSTER_TOL["r"], f"cluster TSQR R {e:.3e}")
        require(r["tsqr"]["orthogonality"] <= CLUSTER_TOL["orthogonality"],
                f"cluster TSQR Q: {r['tsqr']['orthogonality']:.3e}")
        e = rel_err(r["randomized"]["sigma"], one["randomized"]["sigma"])
        require(e <= CLUSTER_TOL["sigma"], f"cluster randomized sigma "
                f"{e:.3e}")
        for key in ("gra", "acc_rb", "sparse"):
            got, want = r["solves"][key], one["solves"][key]
            e = abs(got["objective"] - want["objective"]) \
                / abs(want["objective"])
            require(e <= CLUSTER_TOL["objective"]
                    and got["a_passes"] == want["a_passes"],
                    f"cluster {key}: objective {got['objective']} against "
                    f"{want['objective']} ({e:.3e}), A-passes "
                    f"{got['a_passes']} against {want['a_passes']}")
            require(got["launches"] == got["a_passes"],
                    f"cluster rank {r['rank']} {key}: {got['launches']} "
                    f"launches for {got['a_passes']} A-passes")
        p8, p32 = r["solves"]["psum8_psum8"], r["solves"]["psum8_f32"]
        e = abs(p8["objective"] - p32["objective"]) / abs(p32["objective"])
        require(p8["precision"] == "psum8" and e <= 100 * PSUM8_TOL,
                f"cluster psum8: {p8['precision']}, objective {e:.3e} from "
                "the f32 solve's")
        for tag, errs in r["chunked_low"].items():
            for part, tol in (("gram", CLUSTER_TOL["gram"]),
                              ("f", CLUSTER_TOL["f"]),
                              ("g", CLUSTER_TOL["g"])):
                require(errs[f"{part}_rel"] <= tol,
                        f"cluster rank {r['rank']} {tag}: chunked {part} "
                        f"{errs[f'{part}_rel']:.3e} from eager")
        for name in PATHS["cluster"]:
            require(r["launches"][name] > 0, f"{name} never launched on "
                    f"the cluster path (rank {r['rank']})")
    for key in ("gra", "acc_rb", "sparse", "psum8_psum8"):
        xs = [r["solves"][key]["x"] for r in ranks]
        require(all(torch.equal(x, xs[0]) for x in xs),
                f"cluster {key}: x differs between ranks")
    check_cluster_served(one, ranks)
    head = ranks[0]
    return {
        "world": world, "backend": head["backend"],
        "devices": [r["device"] for r in ranks],
        "path_s": [r["path_s"] for r in ranks],
        "one_rank_path_s": one["path_s"],
        "launches": [r["launches"] for r in ranks],
        "allreduce_ms": head["allreduce_ms"],
        "one_rank_allreduce_ms": one["allreduce_ms"],
        "bodies_ms": head["bodies_ms"],
        "one_rank_bodies_ms": one["bodies_ms"],
        "solves": {k: {kk: v for kk, v in s.items() if kk != "x"}
                   for k, s in head["solves"].items()},
        "one_rank_solves": {k: {kk: v for kk, v in s.items() if kk != "x"}
                            for k, s in one["solves"].items()},
        "sigma_rel": rel_err(head["svd"]["sigma"], one["svd"]["sigma"]),
        "gram_chunked_rel": rel_err(head["gram_chunked"], head["gram"]),
        "chunked_low": {"one_rank": one["chunked_low"],
                        "ranks": [r["chunked_low"] for r in ranks]}}


def check_cluster_served(one: dict, ranks: list) -> None:
    """The served groups and the accelerated elastic group of every rank
    against the one-rank group's: objectives (CLUSTER_SERVE_TOL), x
    normwise, A-passes equal, every rank's launches equal to its
    A-passes, x the same bits on every rank (on every survivor for the
    elastic group); the lost shard's ranks dropped, every rank re-meshed
    once."""
    for r in ranks:
        for key, got in r["served"].items():
            want = one["served"][key]
            eo = max(abs(g - w) / abs(w) for g, w in zip(
                got["objective"], want["objective"]))
            ex = max(rel_err(g, w) for g, w in zip(got["x"], want["x"]))
            require(eo <= CLUSTER_SERVE_TOL["objective"]
                    and ex <= CLUSTER_SERVE_TOL["x"]
                    and got["a_passes"] == want["a_passes"]
                    and got["launches"] == got["a_passes"] > 0,
                    f"cluster served {key} (rank {r['rank']}): objectives "
                    f"{eo:.3e}, x {ex:.3e} from one rank's, A-passes "
                    f"{got['a_passes']} against {want['a_passes']}, "
                    f"{got['launches']} launches")
        e, w = r["elastic"], one["elastic"]
        require(e["remeshes"] == 1 == w["remeshes"]
                and e["casualties"] == [CLUSTER_LOSS["lost_shard"]]
                and e["launches"] == e["a_passes"] > 0,
                f"cluster elastic (rank {r['rank']}): {e['remeshes']} "
                f"re-meshes, casualties {e['casualties']}, "
                f"{e['launches']} launches for {e['a_passes']} A-passes")
    for key in ranks[0]["served"]:
        xs = [r["served"][key]["x"] for r in ranks]
        require(all(torch.equal(x, xs[0]) for x in xs),
                f"cluster served {key}: x differs between ranks")
    lost = CLUSTER_LOSS["lost_shard"] if len(ranks) > 1 else None
    surv = [r["elastic"] for r in ranks if r["rank"] != lost]
    w = one["elastic"]
    for r in ranks:
        require(r["elastic"]["dropped"] == (r["rank"] == lost),
                f"cluster elastic: rank {r['rank']} dropped "
                f"{r['elastic']['dropped']}")
    for e in surv:
        eo = abs(e["objective"] - w["objective"]) / abs(w["objective"])
        ex = rel_err(e["x"], w["x"])
        require(torch.equal(e["x"], surv[0]["x"])
                and eo <= CLUSTER_SERVE_TOL["objective"]
                and ex <= CLUSTER_SERVE_TOL["x"]
                and e["a_passes"] == w["a_passes"]
                and e["iterations"] == w["iterations"]
                == CLUSTER_ELASTIC_ITERS,
                f"cluster elastic survivor: objective {eo:.3e}, x {ex:.3e} "
                f"from one rank's, A-passes {e['a_passes']} against "
                f"{w['a_passes']}, iterations {e['iterations']}")


def run_phase11(info: dict) -> dict:
    """Phase 11: the one-rank group, then the multi-rank group held to
    it (see the comment above CLUSTER_CHUNKS)."""
    from repro_torch.launch import mesh as lmesh

    t11 = time.perf_counter()
    n = torch.cuda.device_count()
    kw = dict(device="cuda", timeout_s=CLUSTER_TIMEOUT_S, deadline_s=900)
    one = lmesh.spawn(cluster_rank, 1, args=(None, None), backend="nccl",
                      **kw)[0]
    backend, world = ("nccl", n) if n >= 2 else ("gloo", 2)
    ranks = lmesh.spawn(cluster_rank, world, args=(one["L0"], one["L0_S"]),
                        backend=backend, **kw)
    for r in [one] + ranks:
        print(f"[cluster] backend {r['backend']}, world {r['world']}, rank "
              f"{r['rank']} on {r['device']} ({r['device_name']}), "
              f"{r['rows'][0]} rows of A and {r['rows'][1]} of S, path "
              f"{r['path_s']:.1f} s")
    rec = check_cluster(one, ranks)
    for who, r in (("one rank", one), (f"{world} ranks", ranks[0])):
        for name, t in r["allreduce_ms"].items():
            print(f"[cluster] all_reduce {name}, {t['bytes']} B, {who} "
                  f"({r['backend']}): median {t['ms']:.3f} ms; "
                  f"{info['nvidia_smi']}")
    for key, s in rec["solves"].items():
        o = rec["one_rank_solves"][key]
        print(f"[cluster] {key}: objective {s['objective']:.9e} against "
              f"{o['objective']:.9e} on one rank, "
              + (f"{s['a_passes']} A-passes ({s['launches']} launches), "
                 if "a_passes" in s else "")
              + f"precision {s['precision']}")
    for who, r in (("one rank", one), (f"{world} ranks", ranks[0])):
        print(f"[cluster] bodies, {who} ({r['backend']}), median ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["bodies_ms"].items())
              + f"; {info['nvidia_smi']}")
    print(f"[cluster] Gram SVD sigma {rec['sigma_rel']:.3e} from one "
          f"rank's; chunked Gram {rec['gram_chunked_rel']:.3e} from eager; "
          f"launches (rank 0) {rec['launches'][0]}")
    for who, low in (("one rank", one["chunked_low"]),
                     (f"{world} ranks", ranks[0]["chunked_low"])):
        for tag, errs in low.items():
            for part in ("gram", "f", "g"):
                require(errs[f"{part}_rel"] <= CLUSTER_TOL[part],
                        f"cluster {who} {tag}: chunked {part} "
                        f"{errs[f'{part}_rel']:.3e} from eager")
        print(f"[cluster] {who}, chunks={CLUSTER_CHUNKS} against eager on "
              "the same strips: " + "; ".join(
                  f"{tag} Gram {e['gram_rel']:.3e}, f {e['f_rel']:.3e}, g "
                  f"{e['g_rel']:.3e}" for tag, e in low.items()))
    rec["served"], rec["elastic"] = {}, {}
    for who, r in (("one rank", one), (f"{world} ranks", ranks[0])):
        for key, sv in r["served"].items():
            o = one["served"][key]
            e = max(rel_err(g, w) for g, w in zip(sv["x"], o["x"]))
            rec["served"].setdefault(key, {})[who] = {
                "ms": sv["ms"], "a_passes": sv["a_passes"],
                "launches": sv["launches"], "x_rel": e}
            print(f"[cluster] served {key}, {who} ({r['backend']}): "
                  f"{CLUSTER_SLOTS} requests x {sv['iterations'][0]} "
                  f"iterations, {sv['a_passes']} group A-passes "
                  f"({sv['launches']} launches), {sv['ms']:.1f} ms"
                  + (f", x {e:.3e} from one rank's" if r is not one else "")
                  + f"; {info['nvidia_smi']}")
        el = r["elastic"]
        rec["elastic"][who] = {k: v for k, v in el.items() if k != "x"}
        print(f"[cluster] elastic acc, {who} ({r['backend']}): device loss "
              f"at iteration {CLUSTER_LOSS['lose_shard_at']}, re-mesh "
              f"{[round(t, 1) for t in el['remesh_ms']]} ms, "
              f"{el['iterations']} iterations, {el['a_passes']} A-passes, "
              f"{el['ms']:.1f} ms, objective {el['objective']:.9e} "
              f"(one rank {one['elastic']['objective']:.9e}); "
              f"{info['nvidia_smi']}")
    rec["served_elastic_s"] = [
        (sum(sv["ms"] for sv in r["served"].values()) + r["elastic"]["ms"])
        / 1e3 for r in [one] + ranks]
    rec["phase_s"] = time.perf_counter() - t11
    print(f"[cluster] phase 11 in {rec['phase_s']:.1f} s, of which the "
          f"served groups and the elastic solve "
          f"{rec['served_elastic_s'][0]:.1f} s on one rank and "
          f"{max(rec['served_elastic_s'][1:]):.1f} s on {world}")
    return rec


# -- phase 12: fault-tolerant solves ------------------------------------------
#
# Phase 3's A (and phase 6's S for the sparse re-mesh), drawn again from
# their seeds once every earlier matrix is freed, through the elastic
# executor (core/optim/elastic): quad/gra at tol 0 runs every one of its
# ELASTIC_ITERS iterations, so its x can be held bit for bit.  The
# checkpointed solve snapshots every ELASTIC_EVERY iterations and is
# abandoned at ELASTIC_CUT; the fault plans inject a failed pass and a NaN
# smooth value (each retried); the deadline request asks for more
# iterations than ELASTIC_DEADLINE_S allows.  Detection runs on the seeded
# synthetic shard times of train/faults (the injected delay is not slept).
ELASTIC_ITERS = 40
ELASTIC_EVERY, ELASTIC_CUT = 10, 20
ELASTIC_FAULTS = dict(fail_steps=(5,), nan_steps=(12,))
ELASTIC_STRAGGLER = dict(shard_delays={0: 0.2}, delay_from=6)
ELASTIC_MONITOR = dict(warmup_steps=2, threshold=2.0, trip_limit=2)
ELASTIC_DEADLINE_S = 0.05
ELASTIC_SERVE = 8              # requests of the elastic server (one group)
ELASTIC_SERVE_ITERS = 60
# The two-rank group: a straggler on shard 0 (A), and shard 1's device
# lost at iteration 3 (S).  The iterations before the re-mesh sum over two
# strips, so they differ from one rank's by rounding, and the group's
# backtracking test (f(x⁺) against the model, in f32 over all rows) may
# fall the other way where a step is close to the line.  The solve on A
# runs to its stop (tol 1e-6, about 50 iterations at cond(A) near 3) and
# is held to the one-rank clean solve (max-abs x within
# tests/test_fault_tolerance.py's 5e-4 of a clean solve, the objective
# within 1e-5 relative).  The one on S runs 30 iterations at tol 0 from
# phase 11's L0 (1.5 x the top eigenvalue of SᵀS), so it backtracks after
# the re-mesh.  Its survivor is held bit for bit to the one-rank solve
# started from the two-rank clean solve's iterate and L at the loss (the
# re-mesh's promise: the same state, the matrix moved, F/G re-seeded),
# step for step in group passes; and the two-rank and one-rank clean
# solves' objectives agree within 1e-5 up to the first iteration whose
# group passes differ (a backtracking test that fell the other way).
# Where no step differs, the survivor is held to the one-rank clean solve
# as on A.
ELASTIC_LOSS = dict(lose_shard_at=3, lost_shard=1)
ELASTIC_CLUSTER = {"A": dict(tol=1e-6, max_iters=300),
                   "S": dict(tol=0.0, max_iters=30)}
ELASTIC_TOL = {"x": 5e-4, "objective": 1e-5, "serve": 1e-5}


def _nosleep(_dt):
    """The injected delays' sleep: detection reads the seeded shard
    times, so the phase spends no wall time on them."""


def elastic_inputs(dev, sparse: bool):
    """Phase 3's A (or phase 6's S) from its seed, and b from generator
    SEED + 12 (SEED + 13 for S): b = A x + 0.5 noise."""
    if sparse:
        S = sparse_matrix(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        xs = torch.randn(N_S, generator=gen, device=dev) / math.sqrt(
            ELL_S * BS_S)
        return S, S.matvec(xs) + 0.5 * torch.randn(M_S, generator=gen,
                                                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = 1.0 + 2.0 * 0.95 ** torch.arange(N, device=dev, dtype=torch.float32)
    A = torch.randn(M, N, generator=gen, device=dev)
    A.mul_(d / math.sqrt(N))
    gen12 = torch.Generator(device=dev).manual_seed(SEED + 12)
    b = A @ torch.randn(N, generator=gen12, device=dev) \
        + 0.5 * torch.randn(M, generator=gen12, device=dev)
    return A, b


def sparse_l0(S, factor: float = 1.5) -> float:
    """`factor` x the top eigenvalue of SᵀS by CLUSTER_POWER_ITERS power
    iterations (1.5: phase 11's L0 of S)."""
    v = torch.ones(N_S, device=S.device) / math.sqrt(N_S)
    for _ in range(CLUSTER_POWER_ITERS):
        w = S.rmatvec(S.matvec(v))
        lam = float(torch.linalg.vector_norm(w))
        v = w / lam
    return factor * lam


def _elastic_case(ops, dev, kernel: str, run) -> dict:
    """One elastic path: the launch counts zeroed just before `run()` and
    read just after, under a telemetry recorder; `run` returns (x, info).
    The record: info, x on the host, wall ms, the launches of `kernel`,
    the group passes of each engine step (its fused_pass spans' tries, a
    step a re-mesh cut short included), the re-mesh and checkpoint spans'
    ms and the checkpoint writes' ms."""
    from repro_torch.launch import telemetry as tel

    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    with tel.recording() as rec:
        t0 = time.perf_counter()
        x, info = run()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    spans = {}
    for s in rec.spans:
        spans.setdefault(s.name, []).append(s.dur_s * 1e3)
    writes = rec.histogram("checkpoint.write_s")
    info = {k: v for k, v in info.items() if k != "trace"}
    return {"info": info, "x": x.detach().cpu(), "wall_ms": wall,
            "launches": counts[kernel], "counts": counts,
            "tries": [s.attrs["tries"] for s in rec.spans
                      if s.name == "solver.fused_pass"],
            "remesh_ms": spans.get("solver.remesh", []),
            "checkpoint_ms": spans.get("solver.checkpoint", []),
            "checkpoint_write_ms": ([writes.sum / writes.count * 1e3]
                                    if writes.count else [])}


def group_run(lin, b, L0: float, iters: int, x0=None, cut: int = 0):
    """quad/gra at tol 0 on a one-slot ElasticGroup stepped `iters` times
    (solve_elastic's loop without its ladder), read after every step:
    (x, info) with the objective of each iteration in info["objectives"]
    and, after iteration `cut`, the iterate and L in info["cut"]."""
    from repro_torch.core.optim.elastic import ElasticGroup

    g = ElasticGroup(lin, "quad", slots=1)
    g.admit_slot(b, tol=0.0, x0=x0, L0=L0)
    objectives = []
    for it in range(1, iters + 1):
        g.step_iteration()
        objectives.append(float(g.state.obj[0]))
        if it == cut:
            at_cut = (g.state.X[0].cpu(), float(g.state.L[0]))
    return g.state.X[0].clone(), {
        "iterations": int(g.state.k[0]), "a_passes": g.a_passes,
        "converged": bool(g.state.done[0]),
        "objective": objectives[-1], "objectives": objectives,
        "cut": at_cut if cut else None}


def elastic_rank(rank: int, L0: float, L0_S: float) -> dict:
    """Phase 12's two-rank cases on one rank of the group
    launch/mesh.spawn started: a straggler re-mesh on A's strips, then on
    S's strips a clean run (its iterate and L at the loss kept) and a
    device loss, each under a recorder with its counts zeroed just before
    and read just after."""
    import torch.distributed as dist
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.core.distmat import types as T
    from repro_torch.core.optim.elastic import ElasticConfig, solve_elastic
    from repro_torch.core.tfocs.linop import LinopMatrix
    from repro_torch.kernels import ops
    from repro_torch.train.faults import FaultPlan, FaultyLinop, FaultyMesh
    from repro_torch.train.straggler import ShardMonitor, StragglerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev)}
    for name, plan, monitor, kernel, L in (
            ("A", ELASTIC_STRAGGLER, True, "fused_grad_multi", L0),
            ("S", ELASTIC_LOSS, False, "fused_grad_bsr_multi", L0_S)):
        mesh = T.make_mesh((world, 1), ("data", "model"), device=dev)
        whole, b = elastic_inputs(dev, sparse=name == "S")
        mat = whole.remesh(mesh) if name == "S" \
            else RowMatrix.create(whole, mesh=mesh)
        del whole
        torch.cuda.empty_cache()
        if name == "S":
            rec["S_clean"] = _elastic_case(
                ops, dev, kernel, lambda: group_run(
                    LinopMatrix(mat), b, L, ELASTIC_CLUSTER["S"]["max_iters"],
                    cut=ELASTIC_LOSS["lose_shard_at"]))
        lin = FaultyLinop(LinopMatrix(mat), FaultPlan(**plan),
                          sleep=_nosleep)
        del mat
        fm = FaultyMesh(mesh)
        cfg = ElasticConfig(
            monitor=ShardMonitor(world, StragglerConfig(**ELASTIC_MONITOR))
            if monitor else None, remesh_to=fm.drop)
        rec[name] = _elastic_case(ops, dev, kernel, lambda: solve_elastic(
            lin, "quad", b, L0=L, elastic=cfg, **ELASTIC_CLUSTER[name]))
        rec[name]["casualties"] = fm.casualties
        del lin, cfg, fm, b
        torch.cuda.empty_cache()
    return rec


def _first_difference(a: list, b: list):
    """The first index where the two lists differ (None where they agree
    over the shorter one's length)."""
    return next((i for i, (u, v) in enumerate(zip(a, b)) if u != v), None)


def run_phase12(info: dict) -> dict:
    """Phase 12: the elastic executor on cuda:0 (see the comment above
    ELASTIC_ITERS); every case zeroes and reads its launch counts, and
    fused_grad_multi (fused_grad_bsr_multi) launches must equal the
    A-passes its solve reports."""
    from repro_torch import api
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.core.optim.elastic import (ElasticConfig,
                                                SolveCheckpoint,
                                                solve_elastic)
    from repro_torch.core.tfocs.linop import LinopMatrix
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.serve import SolverServer
    from repro_torch.train.faults import FaultPlan, FaultyLinop, FaultyMesh
    from repro_torch.train.straggler import ShardMonitor, StragglerConfig

    t12 = time.perf_counter()
    dev = torch.device("cuda", 0)
    A, b = elastic_inputs(dev, sparse=False)
    rm = RowMatrix.create(A, device=dev)
    del A
    L0 = float(api.compute_svd(rm, 1, compute_u=False, mode="gram",
                               device=dev)[1][0]) ** 2
    kw = dict(L0=L0, tol=0.0)
    cases = {}

    def solve(iters=ELASTIC_ITERS, lin=None, **elastic):
        return lambda: solve_elastic(
            lin or LinopMatrix(rm), "quad", b, max_iters=iters,
            elastic=ElasticConfig(**elastic) if elastic else None, **kw)

    cases["clean"] = _elastic_case(ops, dev, "fused_grad_multi", solve())
    with tempfile.TemporaryDirectory() as d:
        def ck():
            return SolveCheckpoint(d, every=ELASTIC_EVERY)
        cases["cut"] = _elastic_case(ops, dev, "fused_grad_multi", solve(
            ELASTIC_CUT, checkpoint=ck()))
        cases["resumed"] = _elastic_case(
            ops, dev, "fused_grad_multi", lambda: solve_elastic(
                LinopMatrix(rm), "quad", b, max_iters=ELASTIC_ITERS,
                resume=True, elastic=ElasticConfig(checkpoint=ck()), **kw))
    cases["faults"] = _elastic_case(ops, dev, "fused_grad_multi", solve(
        lin=FaultyLinop(LinopMatrix(rm), FaultPlan(**ELASTIC_FAULTS),
                        sleep=_nosleep), backoff_s=1e-3))
    def deadline_request():
        res = api.solve(api.SolveRequest(
            A=rm, b=b, tol=0.0, max_iters=100_000, L0=L0,
            deadline_s=ELASTIC_DEADLINE_S, device=dev))
        return res.x, res.info

    cases["deadline"] = _elastic_case(ops, dev, "fused_grad_multi",
                                      deadline_request)
    clean = cases["clean"]
    for key in ("clean", "cut", "faults", "deadline"):
        c = cases[key]
        require(c["launches"] == c["info"]["a_passes"],
                f"elastic {key}: {c['launches']} fused_grad_multi launches "
                f"for {c['info']['a_passes']} A-passes")
    require(cases["cut"]["launches"] + cases["resumed"]["launches"]
            == cases["resumed"]["info"]["a_passes"],
            "elastic resume: launches of the cut and resumed runs "
            f"{cases['cut']['launches']} + {cases['resumed']['launches']} "
            f"!= {cases['resumed']['info']['a_passes']} A-passes")
    require(clean["info"]["iterations"] == ELASTIC_ITERS
            and bool(torch.isfinite(clean["x"]).all()),
            f"elastic clean: {clean['info']}")
    r = cases["resumed"]["info"]
    require(r["resumed_from"] == ELASTIC_CUT and r["iterations"]
            == ELASTIC_ITERS and cases["cut"]["info"]["checkpoint_saves"]
            == ELASTIC_CUT // ELASTIC_EVERY,
            f"elastic resume: {r}, cut {cases['cut']['info']}")
    require(torch.equal(cases["resumed"]["x"], clean["x"]),
            "elastic resume: x differs from the clean solve's")
    f = cases["faults"]["info"]
    require(f["retries"] == 2 and f["iterations"] == ELASTIC_ITERS
            and torch.equal(cases["faults"]["x"], clean["x"]),
            f"elastic faults: {f}, x equal "
            f"{torch.equal(cases['faults']['x'], clean['x'])}")
    dl = cases["deadline"]
    require(dl["info"]["degraded"] == "deadline"
            and dl["info"]["plan"] == "elastic"
            and 0 < dl["info"]["iterations"] < 100_000
            and bool(torch.isfinite(dl["x"]).all()),
            f"elastic deadline: {dl['info']}")

    # The elastic server against the plain one: ELASTIC_SERVE quad/gra
    # requests, one group; the straggler wrapped around the group's linop
    # after its first step (tests/test_fault_tolerance.py's way).
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    B = torch.stack([rm.matvec(torch.randn(N, generator=gen, device=dev))
                     for _ in range(ELASTIC_SERVE)])
    served = {}
    for name in ("plain", "elastic"):
        fm = FaultyMesh(None)
        srv = SolverServer(slots=SLOTS, elastic_factory=(
            lambda: ElasticConfig(
                monitor=ShardMonitor(1, StragglerConfig(**ELASTIC_MONITOR)),
                remesh_to=fm.drop)) if name == "elastic" else None)
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ids = [srv.submit(api.SolveRequest(
            A=rm, b=B[j], L0=L0, tol=0.0, max_iters=ELASTIC_SERVE_ITERS,
            device=dev)) for j in range(ELASTIC_SERVE)]
        srv.step()
        if name == "elastic":
            runner = next(iter(srv._runners.values()))
            runner._eg.linop = FaultyLinop(
                runner._eg.linop, FaultPlan(**ELASTIC_STRAGGLER),
                sleep=_nosleep)
        srv.run()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()["fused_grad_multi"]
        require(launches == srv.stats["a_passes"],
                f"elastic server ({name}): {launches} launches for "
                f"{srv.stats['a_passes']} group A-passes")
        served[name] = {"x": [srv.result(i).x for i in ids],
                        "stats": srv.stats, "wall_ms": wall,
                        "launches": launches}
    require(served["elastic"]["stats"]["remeshes"] >= 1,
            f"elastic server: {served['elastic']['stats']}")
    serve_err = max(rel_err(x, y) for x, y in zip(
        served["elastic"]["x"], served["plain"]["x"]))
    require(serve_err <= ELASTIC_TOL["serve"],
            f"elastic server: answers {serve_err:.3e} from the plain's")

    # The one-rank clean references of the two-rank cases.
    del B, served["plain"]["x"], served["elastic"]["x"]
    one = {"A": _elastic_case(ops, dev, "fused_grad_multi", lambda: (
        solve_elastic(LinopMatrix(rm), "quad", b, L0=L0,
                      **ELASTIC_CLUSTER["A"])))}
    del rm, b
    torch.cuda.empty_cache()
    S, b_s = elastic_inputs(dev, sparse=True)
    L0_S = sparse_l0(S)
    s_iters, loss_at = (ELASTIC_CLUSTER["S"]["max_iters"],
                        ELASTIC_LOSS["lose_shard_at"])
    one["S"] = _elastic_case(
        ops, dev, "fused_grad_bsr_multi", lambda: group_run(
            LinopMatrix(S), b_s, L0_S, s_iters))

    t0 = time.perf_counter()
    ranks = lmesh.spawn(elastic_rank, 2, args=(L0, L0_S),
                        backend="nccl" if torch.cuda.device_count() >= 2
                        else "gloo", device="cuda",
                        timeout_s=CLUSTER_TIMEOUT_S, deadline_s=900)
    spawn_s = time.perf_counter() - t0
    # The one-rank solve from the two-rank clean solve's state at the loss.
    x_cut, L_cut = ranks[0]["S_clean"]["info"]["cut"]
    stitched = _elastic_case(
        ops, dev, "fused_grad_bsr_multi", lambda: group_run(
            LinopMatrix(S), b_s, L_cut, s_iters - loss_at,
            x0=x_cut.to(dev)))
    del S, b_s
    torch.cuda.empty_cache()
    dropped = {"A": next(iter(ELASTIC_STRAGGLER["shard_delays"])),
               "S": ELASTIC_LOSS["lost_shard"]}
    cluster = {}
    for name, kernel in (("A", "fused_grad_multi"),
                         ("S", "fused_grad_bsr_multi")):
        rs = [r[name] for r in ranks]
        surv = [c for i, c in enumerate(rs) if i != dropped[name]]
        lost = rs[dropped[name]]
        for i, c in enumerate(rs):
            require(c["casualties"] == [dropped[name]]
                    and c["info"]["remeshes"] == 1
                    and c["launches"] == c["info"]["a_passes"] > 0,
                    f"elastic cluster {name} rank {i}: {c['info']}, "
                    f"casualties {c['casualties']}, {c['launches']} "
                    f"{kernel} launches")
        require(lost["info"].get("dropped") is True
                and all("dropped" not in c["info"] for c in surv),
                f"elastic cluster {name}: rank {dropped[name]} not dropped")
        require(all(torch.equal(c["x"], surv[0]["x"]) for c in surv),
                f"elastic cluster {name}: survivors' x differ")
        ref = one[name]
        ex = max_abs(surv[0]["x"], ref["x"])
        eo = abs(surv[0]["info"]["objective"] - ref["info"]["objective"]) \
            / abs(ref["info"]["objective"])
        print(f"[elastic] {len(rs)} ranks ({ranks[0]['backend']}) on {name}: "
              f"rank {dropped[name]} dropped, re-mesh ms "
              f"{[c['remesh_ms'] for c in rs]}, wall ms "
              f"{[round(c['wall_ms'], 1) for c in rs]} (one rank "
              f"{ref['wall_ms']:.1f}), A-passes "
              f"{[c['info']['a_passes'] for c in rs]} (one rank "
              f"{ref['info']['a_passes']}), x {ex:.3e} (max abs) and "
              f"objective {eo:.3e} from one rank's; {info['nvidia_smi']}")
        flips = {}
        if name == "S":
            # Group passes a step: the one-rank and two-rank clean runs,
            # the survivor (its step at the loss, cut short by the
            # re-mesh, left out) and the one-rank run from the loss.
            two = ranks[0]["S_clean"]
            steps = {"one rank": ref["tries"], "two ranks": two["tries"],
                     "survivor": (surv[0]["tries"][:loss_at]
                                  + surv[0]["tries"][loss_at + 1:]),
                     "from the loss": stitched["tries"]}
            flips = {k: _first_difference(steps["one rank"], v)
                     for k, v in steps.items()
                     if k in ("two ranks", "survivor")}
            d = _first_difference(ref["tries"][loss_at:], stitched["tries"])
            flips["from the loss"] = None if d is None else loss_at + d
            upto = flips["two ranks"]
            o1 = ref["info"]["objectives"][:upto]
            o2 = two["info"]["objectives"][:upto]
            eo_before = max((abs(u - v) / abs(u) for u, v in zip(o1, o2)),
                            default=0.0)
            es = max_abs(surv[0]["x"], stitched["x"])
            print(f"[elastic] S group passes a step: "
                  + "; ".join(f"{k} {v}" for k, v in steps.items())
                  + f"; first step that differs from one rank's: {flips}; "
                  f"objectives of two ranks and one before it "
                  f"{eo_before:.3e} apart (relative); survivor "
                  f"{es:.3e} (max abs) from the one-rank run from the "
                  f"loss; {info['nvidia_smi']}")
            require(two["launches"] == two["info"]["a_passes"]
                    and stitched["launches"] == stitched["info"]["a_passes"],
                    f"elastic cluster S: clean {two['launches']} launches "
                    f"for {two['info']['a_passes']} A-passes, from the loss "
                    f"{stitched['launches']} for "
                    f"{stitched['info']['a_passes']}")
            require(eo_before <= ELASTIC_TOL["objective"],
                    f"elastic cluster S: two ranks' objectives {eo_before:.3e}"
                    " from one rank's before any step differs")
            require(torch.equal(surv[0]["x"], stitched["x"])
                    and steps["survivor"][loss_at:] == stitched["tries"]
                    and sum(stitched["tries"]) > len(stitched["tries"]),
                    "elastic cluster S: the survivor is not the one-rank run "
                    f"from the loss bit for bit ({es:.3e} max abs), or no "
                    "step backtracked after the re-mesh")
        if flips.get("survivor") is None:
            require(ex <= ELASTIC_TOL["x"] and eo <= ELASTIC_TOL["objective"]
                    and surv[0]["info"]["converged"]
                    == ref["info"]["converged"],
                    f"elastic cluster {name}: x {ex:.3e}, objective "
                    f"{eo:.3e} from one rank's, {surv[0]['info']}")
        cluster[name] = {
            "world": len(rs), "backend": ranks[0]["backend"],
            "dropped_rank": dropped[name], "x_max_abs": ex,
            "objective_rel": eo,
            "wall_ms": [c["wall_ms"] for c in rs],
            "remesh_ms": [c["remesh_ms"] for c in rs],
            "a_passes": [c["info"]["a_passes"] for c in rs],
            "launches": [c["launches"] for c in rs],
            "one_rank": {"wall_ms": ref["wall_ms"],
                         "a_passes": ref["info"]["a_passes"]},
            "first_step_differing": flips}
    launches = {k: 0 for k in ops.launch_counts()}
    for c in list(cases.values()) + [ranks[0]["A"], ranks[0]["S"]]:
        for k, v in c["counts"].items():
            launches[k] += v
    launches["fused_grad_multi"] += served["elastic"]["launches"]
    for name in PATHS["elastic"]:
        require(launches[name] > 0, f"{name} never launched on the "
                "elastic path")

    rec = {"cases": {k: {"info": c["info"], "wall_ms": c["wall_ms"],
                         "launches": c["launches"],
                         "remesh_ms": c["remesh_ms"],
                         "checkpoint_ms": c["checkpoint_ms"],
                         "checkpoint_write_ms": c["checkpoint_write_ms"]}
                     for k, c in cases.items()},
           "server": {k: {kk: v for kk, v in s.items() if kk != "x"}
                      for k, s in served.items()},
           "serve_rel": serve_err, "cluster": cluster,
           "spawn_s": spawn_s, "launches": launches,
           "phase_s": time.perf_counter() - t12}
    for k, c in rec["cases"].items():
        print(f"[elastic] {k}: {c['info']['iterations']} iterations, "
              f"{c['info']['a_passes']} A-passes ({c['launches']} "
              f"fused_grad_multi launches), {c['wall_ms']:.1f} ms, "
              f"degraded {c['info']['degraded']}, retries "
              f"{c['info']['retries']}, saves "
              f"{c['info']['checkpoint_saves']}"
              + (f", checkpoint {c['checkpoint_ms']} ms (writes "
                 f"{c['checkpoint_write_ms']} ms)"
                 if c["checkpoint_ms"] else "")
              + f"; {info['nvidia_smi']}")
    for k, s in rec["server"].items():
        print(f"[elastic] server {k}: {ELASTIC_SERVE} requests, "
              f"{s['stats']['a_passes']} group A-passes, remeshes "
              f"{s['stats']['remeshes']}, {s['wall_ms']:.1f} ms; "
              f"{info['nvidia_smi']}")
    print(f"[elastic] phase 12 in {rec['phase_s']:.1f} s (spawn "
          f"{spawn_s:.1f} s); launches {launches}")
    return rec


# -- phase 13: fp8 storage (float8_e4m3fn, float8_e5m2) on the main path ---

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
# Each fp8 type's tag, type, mantissa bits and smallest normal exponent
# (an fp8 step is 2^(e - mantissa) at 2^e <= |x| < 2^(e+1)); its path runs
# in this order.
FP8_TYPES = (("e4m3", E4M3, 3, -6), ("e5m2", E5M2, 2, -14))
# The casts' edge values.  e4m3: the largest finite value, the rounding
# midpoint 464 (ties to 448), past it (NaN in the reference, where torch
# saturates), infinities, NaN, signed zero and the subnormal steps.
# e5m2: the largest finite value 57344, below and at the overflow midpoint
# 61440 (ties to inf in both), past it, infinities, NaN (the reference's
# 0x7E from f32, where torch writes 0x7F), signed zero, the subnormals.
FP8_EDGES = {
    "e4m3": (448.0, -448.0, 460.0, 463.9, 464.0, -464.0, 464.1, 500.0,
             -1000.0, math.inf, -math.inf, math.nan, -0.0, 2.0 ** -10,
             2.0 ** -9, 1.5 * 2.0 ** -9, 0.3),
    "e5m2": (57344.0, -57344.0, 61439.0, 61440.0, -61440.0, 1e5, math.inf,
             -math.inf, math.nan, -0.0, 2.0 ** -16, 2.0 ** -17,
             1.5 * 2.0 ** -16, 0.3)}
# Edge index -> the reference's code where torch's own cast gives another.
FP8_EDGE_CODES = {"e4m3": {7: 0x7F, 8: 0xFF, 4: 0x7E},
                  "e5m2": {3: 0x7C, 4: 0xFC, 8: 0x7E}}
FP8_SLOTS = (8, 40)            # fused_grad_multi's fp8 slot counts
# Phase 13's solves: (loss, method, cap, tol).  acc_rb stops at a relative
# step of 1e-7: at phase 4's 1e-9 (an exactly zero f32 step) its momentum
# kept moving x by an ulp on e4m3 A until the cap of 100, within 1e-5 of
# the optimum all the same (chip run on an H100).
FP8_SOLVES = (("quad", "gra", 200, 1e-9), ("quad", "acc_rb", 100, 1e-7),
               ("logistic", "gra", 300, 1e-9))
FP8_CAST_ROWS = 1 << 18        # rows of A cast on the CPU at a time
# The float64 logistic optima (logistic_optima64): Newton stops once each
# decrement's half, the gap to second order, is below this share of f.
LOGISTIC_DECREMENT = 1e-10
LOGISTIC_NEWTON_STEPS = 25
# Phase 13's server: (method, loss, cap, requests) on the fp8 A.
FP8_SERVE = (("gra", "quad", 200, 8), ("acc_rb", "quad", 100, 4),
             ("lbfgs", "logistic", 100, 4))
FP8_REFUSED = ("matvec", "lanczos", "randomized", "tsqr", "dimsum",
               "logistic_acc")
# The library call of each fp8 row: torch._scaled_mm takes both operands
# in fp8 with the second column-major, which neither A's Gram (A^T A of a
# row-major A), gemm's f32 B nor randsketch's AᵀQ gives it, so each row's
# bf16 library call runs on bf16 copies (fp8 is exact in bf16; the copies
# are not timed).
FP8_LIBRARY = {"tsgram": "torch.mm(a.T, a) on a bf16 copy of A (copy not "
                         "timed)",
               "gemm": "torch.mm(a, b) on bf16 copies of A and B (copies "
                       "not timed)",
               "randsketch": "torch.mm(a.T, q) on bf16 copies of A and Q "
                             "(copies not timed)"}


def fp8_steps_ok(got: torch.Tensor, want: torch.Tensor, mant: int,
                 emin: int) -> bool:
    """Each entry within one fp8 step of `want`'s (2^(e - mant) at 2^e <=
    |want| < 2^(e+1), floored at the smallest normal 2^emin); NaN where
    `want` is."""
    g, w = got.double(), want.double()
    nan = torch.isnan(w)
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** emin)))
    ok = (g - w).abs() <= torch.exp2(e - mant)
    return bool((torch.where(nan, torch.isnan(g), ok)).all())


def fp8_cast(A: torch.Tensor, tag: str, dtype) -> tuple[torch.Tensor, dict]:
    """A cast to `dtype` on the card (kernels/dtypes.cast: to_e4m3 or
    to_e5m2), checked against the same helper on the CPU, chunk by chunk
    of A and on the edge values."""
    from repro_torch.kernels.dtypes import cast

    t0 = time.perf_counter()
    A8 = cast(A, dtype)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    edges = torch.tensor(FP8_EDGES[tag])
    card = cast(edges.to(A.device), dtype).view(torch.uint8).cpu()
    require(torch.equal(card, cast(edges, dtype).view(torch.uint8)),
            f"{tag} cast: the card's edge codes {card.tolist()} differ from "
            "the CPU's")
    for i, code in FP8_EDGE_CODES[tag].items():
        require(int(card[i]) == code, f"{tag} cast: {FP8_EDGES[tag][i]} -> "
                f"{int(card[i]):#x}, the reference's {code:#x}")
    t0 = time.perf_counter()
    for i in range(0, M, FP8_CAST_ROWS):
        cpu = cast(A[i:i + FP8_CAST_ROWS].cpu(), dtype).view(torch.uint8)
        require(torch.equal(A8[i:i + FP8_CAST_ROWS].view(torch.uint8).cpu(),
                            cpu), f"{tag} cast: rows {i}.. differ between "
                "the card and the CPU")
    rec = {"card_cast_ms": card_s * 1e3,
           "cpu_check_s": time.perf_counter() - t0,
           "edge_codes": card.tolist()}
    print(f"[{tag}] cast of A on the card {rec['card_cast_ms']:.1f} ms, "
          f"bit for bit the CPU's (checked in {rec['cpu_check_s']:.1f} s), "
          f"edges {rec['edge_codes']}")
    return A8, rec


def fp8_record(rec: dict, ms, plain_ms, bound_ms_by, route_ms,
               library_ms=None, library_call=None) -> dict:
    """A row's fp8 readings: its bound at the card's rate for the operand
    types, and beside it `route_ms`, the bound of the route the kernel
    runs (f32 FMA, 16-bit mma.sync, TF32), which the model prices."""
    rec.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
                "bound_by": bound_ms_by[1], "bound_route_ms": route_ms,
                "library_ms": library_ms, "library_call": library_call})
    return rec


def check_fp8_kernels(A8: torch.Tensor, gen, tag: str, mant: int,
                      emin: int) -> dict:
    """Rows 1-4 on fp8 A against their plain versions (TOL), each timed
    beside plain, its bound on its route and a library call where one
    computes the same function; tsgram and gemm also on A's ragged fp8
    view against its aligned copy, bit for bit."""
    from repro_torch.kernels.dtypes import cast
    from repro_torch.kernels import fusedgrad, gemm, tsgram

    dev = A8.device
    out = {}
    x = torch.randn(N, generator=gen, device=dev)
    w = torch.rand(M, generator=gen, device=dev)
    w[-(M // 64):] = 0.0
    z0 = fusedgrad.fused_grad_plain(A8, x, torch.zeros(M, device=dev), w,
                                    loss="quad")[2]
    fg = {}
    for loss in fusedgrad.LOSSES:
        t = targets(loss, z0, gen)
        got = fusedgrad.fused_grad(A8, x, t, w, loss=loss, param=0.5)
        want = fusedgrad.fused_grad_plain(A8, x, t, w, loss=loss, param=0.5)
        torch.cuda.synchronize()
        errs = {k: rel_err(g, p) for k, g, p in zip("fgz", got, want)}
        for k, e in errs.items():
            require(e <= TOL[k], f"fused_grad {tag} {loss}: {k} relative "
                    f"error {e:.3e} > {TOL[k]}")
        again = fusedgrad.fused_grad(A8, x, t, w, loss=loss, param=0.5)
        require(all(torch.equal(u, v) for u, v in zip(got, again)),
                f"fused_grad {tag} {loss}: two runs differ")
        rec = {"rel_err": errs,
               "max_abs_err": max(max_abs(g, p) for g, p in zip(got, want))}
        if loss == "quad":
            fp8_record(
                rec, time_ms(lambda: fusedgrad.fused_grad(A8, x, t, w,
                                                          loss="quad")),
                time_ms(lambda: fusedgrad.fused_grad_plain(A8, x, t, w,
                                                           loss="quad")),
                multi_bound(1, 1), multi_route_ms(1))
        fg[loss] = rec
        del got, want, again
    out["fused_grad"] = fg

    multi = {}
    Af = A8.float()
    for k in FP8_SLOTS:
        X = torch.randn(k, N, generator=gen, device=dev)
        W = torch.rand(k, M, generator=gen, device=dev)
        W[:, -(M // 64):] = 0.0
        Z0 = X @ Af.T
        rec = {}
        for loss in (fusedgrad.LOSSES if k == 8 else ("quad",)):
            Tg = targets(loss, Z0, gen)
            got = one_launch(fusedgrad.fused_grad_multi,
                             lambda: fusedgrad.fused_grad_multi(
                                 A8, X, Tg, W, loss=loss, param=0.5),
                             f"fused_grad_multi {tag} k={k} {loss}")
            want = fusedgrad.fused_grad_multi_plain(A8, X, Tg, W, loss=loss,
                                                    param=0.5)
            torch.cuda.synchronize()
            errs = {q: rel_err(g, p) for q, g, p in zip("fgz", got, want)}
            for q, e in errs.items():
                require(e <= TOL[q], f"fused_grad_multi {tag} k={k} {loss}: "
                        f"{q} relative error {e:.3e} > {TOL[q]}")
            # Slot 0 is the one-slot launch's bits (fused_grad).
            one = fusedgrad.fused_grad(A8, X[0], Tg[0], W[0], loss=loss,
                                       param=0.5)
            torch.cuda.synchronize()
            require(all(torch.equal(u, v[0]) for u, v in zip(one, got)),
                    f"fused_grad_multi {tag} k={k} {loss}: slot 0 differs "
                    "from fused_grad")
            rec[loss] = {"rel_err": errs, "max_abs_err": max(
                max_abs(g, p) for g, p in zip(got, want))}
            if loss == "quad":
                fp8_record(
                    rec, time_ms(lambda: fusedgrad.fused_grad_multi(
                        A8, X, Tg, W, loss="quad")),
                    time_ms(lambda: fusedgrad.fused_grad_multi_plain(
                        A8, X, Tg, W, loss="quad"), reps=3),
                    multi_bound(k, 1), multi_route_ms(k))
            del got, want, one, Tg
        multi[k] = rec
        del X, W, Z0
    del Af
    torch.cuda.empty_cache()
    out["fused_grad_multi"] = multi

    # tsgram: on its bf16 tensor-core route, and on the ragged view.
    got = tsgram.tsgram(A8, out_dtype=torch.float32)
    want = tsgram.tsgram_plain(A8, torch.float32)
    torch.cuda.synchronize()
    e = rel_err(got, want)
    require(e <= TOL["tsgram"], f"tsgram {tag}: relative error {e:.3e}")
    require(torch.equal(got, got.T), f"tsgram {tag}: not symmetric")
    require(torch.equal(got, tsgram.tsgram(A8, out_dtype=torch.float32)),
            f"tsgram {tag}: two runs differ")
    a16 = A8.to(torch.bfloat16)
    tb = tsgram_bound(M, N, A8.dtype)
    rec = fp8_record(
        {"rel_err": e, "max_abs_err": max_abs(got, want)},
        time_ms(lambda: tsgram.tsgram(A8, out_dtype=torch.float32)),
        time_ms(lambda: tsgram.tsgram_plain(A8, torch.float32), reps=3),
        (tb["bound_ms"], tb["bound_by"]), tb["bound_route_ms"],
        time_ms(lambda: torch.mm(a16.T, a16)), FP8_LIBRARY["tsgram"])
    del got, want
    ragged = A8.view(-1)[1:1 + M * (N - 1)].view(M, N - 1)
    require(ragged.data_ptr() % 16 != 0, f"the ragged {tag} view is aligned")
    got = tsgram.tsgram(ragged, out_dtype=torch.float32)
    require(torch.equal(got, tsgram.tsgram(ragged.clone(),
                                           out_dtype=torch.float32)),
            f"tsgram {tag}: the ragged view and its aligned copy differ")
    e_r = rel_err(got, tsgram.tsgram_plain(ragged, torch.float32))
    require(e_r <= TOL["tsgram"], f"tsgram {tag} ragged: {e_r:.3e}")
    rec["ragged"] = {"rel_err": e_r, "bits_equal_aligned_copy": True,
                     "ms": time_ms(lambda: tsgram.tsgram(
                         ragged, out_dtype=torch.float32), reps=3)}
    out["tsgram"] = rec
    del got

    # gemm: U recovery's A x 16 columns, f32 and fp8 out.
    B = torch.randn(N, K_GEMM, generator=gen, device=dev) / math.sqrt(N)
    got = gemm.gemm(A8, B, out_dtype=torch.float32)
    want = gemm.gemm_plain(A8, B, torch.float32)
    torch.cuda.synchronize()
    e = rel_err(got, want)
    require(e <= TOL["gemm"], f"gemm {tag}: relative error {e:.3e}")
    require(torch.equal(got, gemm.gemm(A8, B, out_dtype=torch.float32)),
            f"gemm {tag}: two runs differ")
    c8 = gemm.gemm(A8, B)
    require(c8.dtype == A8.dtype and torch.equal(
        c8.view(torch.uint8), cast(got, A8.dtype).view(torch.uint8)),
        f"gemm {tag}: the {tag} C is not the f32 C's cast")
    require(fp8_steps_ok(c8.float(), gemm.gemm_plain(A8, B).float(), mant,
                         emin),
            f"gemm {tag}: C off plain's by more than one {tag} step")
    B16 = B.to(torch.bfloat16)
    rec = fp8_record(
        {"rel_err": e, "max_abs_err": max_abs(got, want),
         "fp8_out_within_one_step": True},
        time_ms(lambda: gemm.gemm(A8, B, out_dtype=torch.float32)),
        time_ms(lambda: gemm.gemm_plain(A8, B, torch.float32), reps=3),
        (gemm_bound(A8, B)["bound_ms"], gemm_bound(A8, B)["bound_by"]),
        gemm_bound(A8, B)["bound_ms"],
        time_ms(lambda: torch.mm(a16, B16)), FP8_LIBRARY["gemm"])
    rec["ms_fp8_out"] = time_ms(lambda: gemm.gemm(A8, B))
    ragged = A8.view(-1)[1:1 + M * (N - 1)].view(M, N - 1)
    got = gemm.gemm(ragged, B[:N - 1], out_dtype=torch.float32)
    require(rel_err(got, gemm.gemm_plain(ragged, B[:N - 1], torch.float32))
            <= TOL["gemm"], f"gemm {tag}: the ragged view is off plain")
    require(torch.equal(got, gemm.gemm(ragged.clone(), B[:N - 1],
                                       out_dtype=torch.float32)),
            f"gemm {tag}: the ragged view and its aligned copy differ")
    rec["ragged_bits_equal"] = True
    out["gemm"] = rec
    del got, want, c8, a16, ragged
    torch.cuda.empty_cache()

    for name in ("fused_grad", "fused_grad_multi", "tsgram", "gemm"):
        recs = {"fused_grad": {"": fg["quad"]},
                "fused_grad_multi": {f" k={k}": multi[k]
                                     for k in FP8_SLOTS}}.get(
            name, {"": out[name]})
        for key, r in recs.items():
            print(f"[{tag}] {name}{key} kernel {r['ms']:9.3f} ms | plain "
                  f"{r['plain_ms']:9.3f} ms | library "
                  + ("     n/a" if r["library_ms"] is None
                     else f"{r['library_ms']:9.3f} ms")
                  + f" | bound {r['bound_ms']:8.3f} ms ({r['bound_by']}), "
                  f"share {r['bound_ms'] / r['ms']:.3f}; route bound "
                  f"{r['bound_route_ms']:.3f} ms")
    return out


def fp8_model_bounds(kernels: dict, tag: str, dtype) -> dict:
    """The built-in model at efficiency 1 prices each fp8 row at its
    route's bound within 1%: the route each kernel runs (fma, bf16,
    tf32), not the card's fastest rate for the operand types, which the
    bound in the kernels line takes (fp8 tensor cores for the Gram, two
    TF32 products for fp8 A against f32)."""
    from repro_torch.kernels import autotune as at

    name8 = _machine.dtype_name(dtype)
    dims = {"fused_grad": {"m": M, "n": N},
            "fused_grad_multi": {"m": M, "n": N, "k": SLOTS},
            "tsgram": {"m": M, "n": N},
            "gemm": {"m": M, "k": N, "n": K_GEMM}}
    recs = {"fused_grad": kernels["fused_grad"]["quad"],
            "fused_grad_multi": kernels["fused_grad_multi"][SLOTS],
            "tsgram": kernels["tsgram"], "gemm": kernels["gemm"]}
    out = {}
    for name, d in dims.items():
        model = at.model_time(name, at.legacy(name, d, name8), d, name8,
                              machine=_machine.H100) * 1e3
        b = recs[name]["bound_route_ms"]
        out[name] = {"model_ms": model, "bound_route_ms": b,
                     "route": at.cost_terms(name, at.legacy(name, d, name8),
                                            d, name8).route}
        require(abs(model - b) <= 0.01 * b, f"{name} {tag}: modeled "
                f"{model:.4f} ms at efficiency 1, route bound {b:.4f} ms")
    print(f"[{tag}] model at efficiency 1 against the route's bound: "
          + ", ".join(
              f"{k} {v['model_ms']:.3f}/{v['bound_route_ms']:.3f} ms "
              f"({v['route']})" for k, v in out.items()))
    return out


def fp8_refusals(api, ops, rm8, b, tag: str) -> dict:
    """Each path the reference refuses on fp8 raises TypeError on the
    card with no launch."""
    from repro_torch.core.linalg.tsqr import tsqr

    dev = rm8.device
    calls = {
        "matvec": lambda: rm8.matvec(torch.ones(N, device=dev)),
        "lanczos": lambda: api.svd(api.SvdRequest(A=rm8, k=K_SVD,
                                                  mode="lanczos",
                                                  device=dev)),
        "randomized": lambda: api.svd(api.SvdRequest(
            A=rm8, k=K_SVD, mode="randomized", device=dev)),
        "tsqr": lambda: tsqr(rm8),
        "dimsum": lambda: api.similarities(api.SimilarityRequest(
            A=rm8, device=dev)),
        "logistic_acc": lambda: api.solve(api.SolveRequest(
            A=rm8, b=b, loss="logistic", method="acc", max_iters=3,
            device=dev))}
    out = {}
    for name in FP8_REFUSED:
        ops.reset_launch_counts()
        try:
            calls[name]()
        except TypeError as err:
            out[name] = str(err)[:120]
        else:
            raise CheckFailed(f"{tag} {name}: no TypeError")
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        require(not launched, f"{tag} {name}: launched {launched} before "
                "raising")
    print(f"[{tag}] refused with TypeError and no launch: "
          f"{', '.join(FP8_REFUSED)}")
    return out


def check_fp8_randsketch(dev, gen) -> dict:
    """Row 5 on fp8 A at A_w (2^18 x 16384, r = R_SKETCH, Q f32): for each
    fp8 type, the kernel against randsketch_plain (which widens A
    exactly) within TOL["sketch"], two runs the same bits, timed beside
    plain and mm(a.T, q) on bf16 copies; the bound: one read of A and Q,
    one write of B, or 2 m n r flops twice (A exact in TF32, Q split in
    two) on TF32.  A_w is made from phase 5's seed, cast, and freed."""
    from repro_torch.kernels import randsketch
    from repro_torch.kernels.dtypes import cast

    A_w = wide_matrix(dev, torch.Generator(device=dev).manual_seed(SEED + 5))
    m, n = A_w.shape
    q = torch.randn(m, R_SKETCH, generator=gen, device=dev)
    q16 = q.to(torch.bfloat16)
    out = {}
    for tag, dtype, _, _ in FP8_TYPES:
        a8 = cast(A_w, dtype)
        got = one_launch(randsketch.randsketch,
                         lambda: randsketch.randsketch(
                             a8, q, out_dtype=torch.float32),
                         f"randsketch {tag}")
        want = randsketch.randsketch_plain(a8, q, torch.float32)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        require(e <= TOL["sketch"], f"randsketch {tag}: relative error "
                f"{e:.3e} > {TOL['sketch']}")
        require(torch.equal(got, randsketch.randsketch(
            a8, q, out_dtype=torch.float32)), f"randsketch {tag}: two runs "
            "differ")
        a16 = a8.to(torch.bfloat16)
        b_ms, b_by = bound(m * n + 4 * R_SKETCH * (m + n),
                           2 * 2.0 * m * n * R_SKETCH, "tf32")
        out[tag] = fp8_record(
            {"shape": [m, n, R_SKETCH], "rel_err": e,
             "max_abs_err": max_abs(got, want)},
            time_ms(lambda: randsketch.randsketch(
                a8, q, out_dtype=torch.float32)),
            time_ms(lambda: randsketch.randsketch_plain(
                a8, q, torch.float32), reps=3),
            (b_ms, b_by), b_ms, time_ms(lambda: torch.mm(a16.T, q16)),
            FP8_LIBRARY["randsketch"])
        r = out[tag]
        print(f"[{tag}] randsketch r={R_SKETCH} A_w kernel {r['ms']:9.3f} ms"
              f" | plain {r['plain_ms']:9.3f} ms | library "
              f"{r['library_ms']:9.3f} ms | bound {r['bound_ms']:8.3f} ms "
              f"({r['bound_by']}), share {r['bound_ms'] / r['ms']:.3f}")
        del a8, a16, got, want
        torch.cuda.empty_cache()
    del A_w, q, q16
    torch.cuda.empty_cache()
    return out


def logistic_objectives64(A, Bs, X) -> torch.Tensor:
    """f_j(x_j) = sum_i log(1 + exp(-b_ji (A x_j)_i)) in float64 on the
    dequantized A, for each row b_j of Bs (labels ±1) and x_j of X."""
    X = X.double()
    f = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
    for i, c in chunks(A):
        yz = Bs[:, i:i + ROWS64].double() * (X @ c.T)
        f += torch.logaddexp(torch.zeros_like(yz), -yz).sum(1)
    return f


def logistic_optima64(A, Bs) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The float64 minimizers of logistic_objectives64 for the rows of Bs:
    Newton from x = 0 with a halving step (Armijo, 1/4), the Hessian
    A^T diag(s (1 - s)) A summed a chunk at a time in float64, until
    every Newton decrement's half is below LOGISTIC_DECREMENT f_j (the
    gap to the optimum, to second order).  Returns (X*, f*, steps)."""
    k = Bs.shape[0]
    X = torch.zeros(k, N, dtype=torch.float64, device=A.device)
    f = logistic_objectives64(A, Bs, X)
    for step in range(LOGISTIC_NEWTON_STEPS):
        g = torch.zeros_like(X)
        H = torch.zeros(k, N, N, dtype=torch.float64, device=A.device)
        for i, c in chunks(A):
            b = Bs[:, i:i + ROWS64].double()
            sig = torch.sigmoid(-b * (X @ c.T))
            g -= (b * sig) @ c
            w = sig * (1.0 - sig)
            for j in range(k):
                H[j] += c.T @ (w[j, :, None] * c)
        D = torch.linalg.solve(H, g)
        dec = (g * D).sum(1)
        if bool((0.5 * dec <= LOGISTIC_DECREMENT * f).all()):
            return X, f, step
        t = torch.ones(k, dtype=torch.float64, device=A.device)
        for _ in range(30):
            Xn = X - t[:, None] * D
            fn = logistic_objectives64(A, Bs, Xn)
            ok = fn <= f - 0.25 * t * dec
            if bool(ok.all()):
                break
            t = torch.where(ok, t, 0.5 * t)
        X, f = Xn, fn
    raise CheckFailed(f"logistic float64 optimum: Newton did not converge "
                      f"in {LOGISTIC_NEWTON_STEPS} steps")


def fp8_serve(api, rm8, B_quad, B_log, L0, which) -> list:
    """Phase 13's solve requests in submit order (FP8_SERVE); `which`
    picks rows of each block."""
    reqs, row = [], 0
    for method, loss, iters, count in FP8_SERVE:
        for i in range(count):
            j = row + i if loss == "quad" else i
            if which(i):
                reqs.append(api.SolveRequest(
                    A=rm8, b=B_quad[j] if loss == "quad" else B_log[j],
                    loss=loss, method=method,
                    L0=L0 if loss == "quad" else 0.25 * L0, tol=1e-9,
                    max_iters=iters, device=rm8.device))
        if loss == "quad":
            row += count
    return reqs


def fp8_path(A: torch.Tensor, tag: str, dtype, mant: int, emin: int,
             sketch: dict, rows: list, info: dict) -> dict:
    """Phase 13 for one fp8 type: A cast to it on the card; the cast,
    rows 1-4 on it, then the main path (counts zeroed just before, read
    just after): the Gram SVD, three solves, a server, sketch (one gemm
    launch) and project of A onto the sketch (one randsketch launch, Q in
    A's type); then the refusals.  Adds each kernel row's `tag` readings
    (randsketch's from `sketch`, its A_w readings)."""
    from repro_torch import api
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.kernels import gemm as _gemm
    from repro_torch.kernels import ops
    from repro_torch.kernels import randsketch as _rs
    from repro_torch.kernels.dtypes import cast as _cast
    from repro_torch.launch.serve import SolverServer

    t13 = time.perf_counter()
    dev = A.device
    A8, cast = fp8_cast(A, tag, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    kernels = check_fp8_kernels(A8, gen, tag, mant, emin)
    model = fp8_model_bounds(kernels, tag, dtype)

    # float64 references on the dequantized A, before the counts are zeroed.
    G64 = gram64(A8)
    x_true = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
    z = torch.cat([c @ x_true for _, c in chunks(A8)])
    b_quad = (z + 0.5 * torch.randn(M, generator=gen, device=dev,
                                    dtype=torch.float64)).float()
    b_log = torch.where(z + torch.randn(M, generator=gen, device=dev,
                                        dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    f_star = quad_optimum64(A8, b_quad, G64)
    X_true = torch.randn(12, N, generator=gen, device=dev,
                         dtype=torch.float64)
    Z = torch.cat([c @ X_true.T for _, c in chunks(A8)]).T
    B_quad = (Z + 0.05 * torch.randn(12, M, generator=gen, device=dev,
                                     dtype=torch.float64)).float()
    B_log = torch.where(Z[:4] + torch.randn(4, M, generator=gen, device=dev,
                                            dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    del Z, z
    AtB = sum(c.T @ B_quad[:, i:i + ROWS64].double().T
              for i, c in chunks(A8))
    X_star = torch.linalg.solve(G64, AtB)
    fs_star = 0.5 * ((B_quad.double() ** 2).sum(1) - (X_star * AtB).sum(0))
    w64 = torch.linalg.eigvalsh(G64).flip(0)[:K_SVD]
    s64 = torch.sqrt(w64.clamp_min(0))
    t0 = time.perf_counter()
    Bs_log = torch.cat([b_log[None], B_log])
    X_log, f_log, newton_steps = logistic_optima64(A8, Bs_log)
    newton_s = time.perf_counter() - t0
    del X_log
    rm8 = RowMatrix(rows=A8, n_rows=M)               # no copy

    # -- the fp8 main path: counts zeroed just before, read just after -----
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.svd(api.SvdRequest(A=rm8, k=K_SVD, mode="auto", device=dev))
    torch.cuda.synchronize()
    svd_ms = (time.perf_counter() - t0) * 1e3
    U, s, V = res.factors
    L0 = float(s[0]) ** 2
    solves = []
    for loss, method, iters, tol in FP8_SOLVES:
        rec, sres = run_solve(api, ops, rm8,
                              b_quad if loss == "quad" else b_log, loss=loss,
                              method=method,
                              L0=L0 if loss == "quad" else 0.25 * L0,
                              tol=tol, max_iters=iters)
        rec.update(cap=iters, tol=tol)
        if loss == "quad":
            rec["objective_gap"] = (quad_objective64(A8, b_quad, sres.x)
                                    - f_star) / f_star
        else:
            rec["objective_gap"] = float(
                (logistic_objectives64(A8, b_log[None], sres.x[None])[0]
                 - f_log[0]) / f_log[0])
            hist = sres.info["history"][:rec["iterations"]].tolist()
            rec["first_last_objective"] = [hist[0], hist[-1]]
            rec["descends"] = all(b <= a * (1 + 1e-6)
                                  for a, b in zip(hist, hist[1:])) \
                and hist[-1] < hist[0]
        solves.append(rec)
    grouped = SolverServer(slots=SLOTS)
    ids = [grouped.submit(r) for r in fp8_serve(api, rm8, B_quad, B_log,
                                                L0, lambda i: True)]
    run = drive(grouped)
    t0 = time.perf_counter()
    Y = rm8.sketch(R_SKETCH, seed=SEED)
    proj = rm8.project(Y)
    torch.cuda.synchronize()
    sketch_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    # ------------------------------------------------------------------------

    # Checks of the path, after its counts are read.
    print(f"[{tag}] solves: " + "; ".join(
        f"{r['loss']}/{r['method']} {r['iterations']} iterations, gap "
        f"{r['objective_gap']:.3e}" for r in solves))
    err_s = float(((s.double() - s64).abs() / s64).max())
    require(res.info["plan"] == "gram" and res.info["a_passes"] == 2,
            f"{tag} svd: plan {res.info['plan']}, {res.info['a_passes']} "
            "A-passes")
    require(err_s <= 1e-4, f"{tag} svd: sigma relative error {err_s:.3e}")
    require(U.rows.dtype == dtype, f"{tag} svd: U in {U.rows.dtype}")
    u_plain = _gemm.gemm_plain(A8, V * (1.0 / s)[None, :])
    require(fp8_steps_ok(U.rows.float(), u_plain.float(), mant, emin),
            f"{tag} svd: U off the plain path's U by more than one step")
    u_zero = float(((U.rows.view(torch.uint8) & 0x7F) == 0).float().mean())
    for rec in solves:
        if rec["loss"] == "quad":
            require(rec["objective_gap"] <= 1e-5, f"{tag} quad "
                    f"{rec['method']}: objective gap "
                    f"{rec['objective_gap']:.3e}")
            require(rec["iterations"] < rec["cap"], f"{tag} quad "
                    f"{rec['method']}: ran to its cap of {rec['cap']}")
        else:
            require(rec["descends"], f"{tag} logistic gra: the objective "
                    "does not fall monotonically")
            require(rec["objective_gap"] <= 1e-5, f"{tag} logistic gra: "
                    f"objective gap {rec['objective_gap']:.3e}")
    results = run["results"]
    require(len(results) == len(ids), f"{tag} serve: not every request was "
            "answered")
    gaps = []
    for j, rid in enumerate(ids[:12]):
        r = results[rid]
        require(r.info["plan"] == "fused-group"
                and r.info["a_passes"] == run["observed"][rid],
                f"{tag} serve {rid}: {r.info['plan']}, a_passes "
                f"{r.info['a_passes']} != {run['observed'][rid]}")
        d = r.x.double() - X_star[:, j]
        gaps.append(float(0.5 * d @ G64 @ d / fs_star[j]))
    require(max(gaps) <= 1e-5, f"{tag} serve: quad objective gap "
            f"{max(gaps):.3e}")
    log_obj = [results[rid].info["objective"] for rid in ids[12:]]
    log_gaps = ((logistic_objectives64(A8, B_log, torch.stack(
        [results[rid].x for rid in ids[12:]])) - f_log[1:])
        / f_log[1:]).tolist()
    require(max(log_gaps) <= 1e-5, f"{tag} serve: logistic objective gaps "
            f"{log_gaps} against the float64 optima")
    require(launches["fused_grad_multi"] == grouped.stats["a_passes"],
            f"{tag} serve: {launches['fused_grad_multi']} fused_grad_multi "
            f"launches != {grouped.stats['a_passes']} server A-passes")
    require(launches["fused_grad"] == sum(r["a_passes"] for r in solves),
            f"{tag}: {launches['fused_grad']} fused_grad launches != the "
            "solves' A-passes")
    for name in PATHS[tag]:
        require(launches[name] > 0, f"{name} never launched on the {tag} "
                "path")
    require(launches["randsketch"] == 1 and launches["gemm"] == 2
            and launches["bsr_matvec"] == 0,
            f"{tag} path launched {launches} (gemm: U and the sketch; "
            "randsketch: the projection)")
    # The sketch and the projection against their plain versions: Ω drawn
    # as sketch draws it, Y within one step of the f32 product of the fp8
    # values, B = AᵀY within TOL["sketch"] of plain.
    omega = _cast(torch.randn((N, R_SKETCH), device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(SEED)), dtype)
    y_plain = _gemm.gemm_plain(A8, omega.to(torch.bfloat16))
    require(Y.rows.dtype == dtype and fp8_steps_ok(
        Y.rows.float(), y_plain.float(), mant, emin),
        f"{tag} sketch: Y off plain by more than one step")
    e_proj = rel_err(proj, _rs.randsketch_plain(A8, Y.rows, torch.float32))
    require(e_proj <= TOL["sketch"], f"{tag} project: {e_proj:.3e} from "
            "plain")
    # Two requests of the gra group again at slots=1: the same bits (a
    # slot's kernel sums follow from A alone, and the group engine's
    # per-slot sums run in the same order at k = 1 on the card).
    serial = SolverServer(slots=1)
    sids = [serial.submit(r) for r in fp8_serve(
        api, rm8, B_quad, B_log, L0, lambda i: i < 2)[:2]]
    srun = drive(serial)
    agree = [rel_err(results[rid].x, srun["results"][sid].x)
             for rid, sid in zip(ids[:2], sids)]
    same_bits = [bool(torch.equal(results[rid].x, srun["results"][sid].x))
                 for rid, sid in zip(ids[:2], sids)]
    require(all(same_bits), f"{tag} serve: group and serial x differ by "
            f"{max(agree):.3e}")
    refused = fp8_refusals(api, ops, rm8, b_log, tag)

    path = {"svd": {"ms": svd_ms, "sigma_rel_err": err_s,
                    "a_passes": res.info["a_passes"],
                    "u_zero_share": u_zero, "sigma_1": float(s[0])},
            "solves": solves,
            "logistic_reference": {"newton_steps": newton_steps,
                                   "s": newton_s,
                                   "f_star": f_log.tolist()},
            "serve": {"requests": len(ids), "wall_s": run["wall_s"],
                      "a_passes": grouped.stats["a_passes"],
                      "max_quad_gap": max(gaps),
                      "logistic_objectives": log_obj,
                      "logistic_gaps": log_gaps,
                      "group_serial_rel": agree,
                      "group_serial_same_bits": same_bits},
            "sketch": {"ms": sketch_ms, "project_rel_err": e_proj,
                       "zero_share": float(
                           ((Y.rows.view(torch.uint8) & 0x7F) == 0)
                           .float().mean())},
            "launches": launches}
    print(f"[{tag}] Gram SVD k={K_SVD}: {svd_ms:.1f} ms, sigma error "
          f"{err_s:.3e} against the float64 Gram of the dequantized A, "
          f"{res.info['a_passes']} A-passes, U in {tag} ({u_zero:.3f} of it "
          f"zero)")
    for r in solves:
        print(f"[{tag}] {r['loss']}/{r['method']}: {r['iterations']} "
              f"iterations (cap {r['cap']}, tol {r['tol']:g}), "
              f"{r['a_passes']} A-passes, "
              f"{r['ms']:.1f} ms, {r['ms_per_iteration']:.3f} ms/iteration, "
              f"objective gap {r['objective_gap']:.3e}"
              + ("" if r["loss"] == "quad" else
                 f", objective {r['first_last_objective'][0]:.6e} -> "
                 f"{r['first_last_objective'][1]:.6e}"))
    print(f"[{tag}] server: {len(ids)} requests in {run['wall_s']:.2f} s, "
          f"{grouped.stats['a_passes']} group A-passes, quad gap max "
          f"{max(gaps):.3e}, logistic gap max {max(log_gaps):.3e}, group "
          f"vs serial {max(agree):.3e} (same bits {same_bits})")
    print(f"[{tag}] float64 logistic optima: {newton_steps} Newton steps "
          f"for {Bs_log.shape[0]} label vectors in {newton_s:.1f} s")
    print(f"[{tag}] sketch (r={R_SKETCH}) and project: {sketch_ms:.1f} ms, "
          f"Y within one step of plain, B {e_proj:.3e} from plain")
    print(f"[main path] {tag}: launches {launches}; {info['nvidia_smi']}")

    by_name = {r["name"]: r for r in rows}
    multi = kernels["fused_grad_multi"][SLOTS]
    picks = {"fused_grad": kernels["fused_grad"]["quad"],
             "fused_grad_multi": dict(
                 multi, max_abs_err=multi["quad"]["max_abs_err"]),
             "tsgram": kernels["tsgram"], "gemm": kernels["gemm"],
             "randsketch": sketch}
    kernels["randsketch"] = sketch
    for name, r in picks.items():
        by_name[name][tag] = {
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_route_ms": r["bound_route_ms"],
            "library_ms": r["library_ms"],
            "library_call": r["library_call"], "dtype": tag,
            "checks": kernels[name]}
    for row in rows:
        row["launches_by_path"][tag] = launches.get(row["name"], 0)
    del A8, rm8, U, res, grouped, serial, run, srun, Y, proj, y_plain
    torch.cuda.empty_cache()
    rec = {"cast": cast, "model": model, "path": path, "refused": refused,
           "randsketch": sketch, "phase_s": time.perf_counter() - t13}
    print(f"[{tag}] path in {rec['phase_s']:.1f} s")
    return rec


def run_phase13(rows: list, info: dict, dev: torch.device) -> dict:
    """Phase 13: row 5 on each fp8 type at A_w (check_fp8_randsketch),
    then phase 3's A redrawn from its seed and, for each fp8 type in
    turn, fp8_path.  Adds each kernel row's "e4m3" and "e5m2"
    readings."""
    t13 = time.perf_counter()
    sketch = check_fp8_randsketch(
        dev, torch.Generator(device=dev).manual_seed(SEED + 15))
    A, _ = elastic_inputs(dev, sparse=False)
    rec = {tag: fp8_path(A, tag, dtype, mant, emin, sketch[tag], rows, info)
           for tag, dtype, mant, emin in FP8_TYPES}
    del A
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t13
    print(f"[fp8] phase 13 in {rec['phase_s']:.1f} s")
    return rec


# -- phase 14: BlockMatrix and CoordinateMatrix on a 2 x 2 mesh ------------
# Four ranks on a ("data", "model") = (2, 2) mesh (launch/mesh.spawn): gloo
# ranks sharing the card, NCCL one rank a card where there are four.
# Phase 9 (f)'s two N_BLOCK x N_BLOCK f32 matrices from their seed, each
# rank keeping its 4096 x 4096 tile, multiplied by SUMMA (A's row panel
# gathered along "model", B's column panel along "data", one gemm launch a
# rank) and held to the one-device product (phase 9's path: one gemm of the
# whole) within MESH_TOL, with the matvec family (normwise against the
# one-device BlockMatrix's), the norm and the transpose (bit for bit); then
# phase 9 (e)'s CoordinateMatrix of 2^27 entries sharded by position over
# "data" (the two "model" ranks of a shard hold the same entries): its
# products against the one-device matrix's on rank 0, and its Lanczos SVD
# (k = K_SVD) against phase 9's sigma.  Then the survivor path: row shard
# MESH_DROP dropped (train/elastic.survivor_mesh, every rank making its
# groups), both types made again on the surviving (1, 2) mesh and run
# there, against the same one-device references.
MESH_SHAPE = (2, 2)
MESH_DROP = 1
MESH_TOL = {"product": 1e-5, "vector": 1e-5, "sigma": 1e-4}
MESH_REPS = 5


def mesh_rank(rank: int, sigma_c: list) -> dict:
    """Phase 14 on one rank of the four launch/mesh.spawn started: the
    path with the counts zeroed just before and read just after, then
    the checks' one-device references and the steps' and all_gathers'
    host-clock ms.  Returns this rank's numbers."""
    import torch.distributed as dist
    from repro_torch import api, compat
    from repro_torch.core.distmat import BlockMatrix, CoordinateMatrix
    from repro_torch.core.distmat import types as T
    from repro_torch.kernels import gemm as _gemm
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = T.make_mesh(MESH_SHAPE, ("data", "model"), device=dev)
    r, c = mesh.index("data"), mesh.index("model")
    rec = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(dev),
           "grid": [r, c]}
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    a = torch.randn(N_BLOCK, N_BLOCK, generator=gen, device=dev)
    b = torch.randn(N_BLOCK, N_BLOCK, generator=gen, device=dev)
    gv = torch.Generator(device=dev).manual_seed(SEED + 14)
    v = torch.randn(N_BLOCK, generator=gv, device=dev)
    u = torch.randn(N_BLOCK, generator=gv, device=dev)
    X = BlockMatrix.create(a, mesh=mesh)
    Y = BlockMatrix.create(b, mesh=mesh)
    ri, ci, va, _ = coordinate_entries(dev)
    C = CoordinateMatrix.create(ri, ci, va, (M_C, N_C), mesh=mesh)
    x_c = torch.randn(N_C, generator=gv, device=dev)
    y_c = torch.randn(M_C, generator=gv, device=dev)
    X.validate()
    opts = {"max_restarts": COO_RESTARTS}

    # -- the mesh path: counts zeroed just before, read just after --------
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    P = X.multiply(Y)
    prods = {"matvec": X.matvec(v), "rmatvec": X.rmatvec(u),
             "matvec_model_sharded": X.matvec_model_sharded(
                 X._model_strip(v)),
             "rmatvec_model_sharded": X.rmatvec_model_sharded(u),
             "frobenius": X.frobenius_norm()}
    Xt = X.transpose()
    coo = {"matvec": C.matvec(x_c), "rmatvec": C.rmatvec(y_c)}
    t_svd = time.perf_counter()
    svd = api.svd(api.SvdRequest(A=C, k=K_SVD, mode="lanczos", options=opts,
                                 device=dev))
    torch.cuda.synchronize(dev)
    rec["svd_ms"] = (time.perf_counter() - t_svd) * 1e3
    rec["path_s"] = time.perf_counter() - t0
    rec["launches"] = ops.launch_counts()
    # -----------------------------------------------------------------------
    surv = survivor_path(mesh, a, b, v, u, (ri, ci, va), x_c, y_c, opts, dev)
    s = svd.factors[1].double().cpu()
    want_s = torch.tensor(sigma_c, dtype=torch.float64)
    rec["svd"] = {"sigma_rel": float(((s - want_s).abs() / want_s).max()),
                  "op_calls": svd.info["op_calls"],
                  "restarts": svd.info["restarts"],
                  "converged": svd.info["converged"]}
    mr, nc = X.block_shape
    rows, cols = slice(r * mr, (r + 1) * mr), slice(c * nc, (c + 1) * nc)
    # The one-device BlockMatrix (phase 9's product: one gemm of the whole).
    X1 = BlockMatrix.create(a, device=dev)
    P1 = X1.multiply(BlockMatrix.create(b, device=dev)).data
    sq = torch.stack([((P.data - P1[rows, cols]).double() ** 2).sum(),
                      (P1[rows, cols].double() ** 2).sum()])
    # Each tile once: the two "model" ranks of a row panel hold
    # different tiles, so the sum over the whole mesh is the product's.
    sq = compat.psum(sq, mesh, mesh.axis_names)
    rec["product_rel"] = float(torch.sqrt(sq[0] / sq[1]))
    want = {"matvec": X1.matvec(v)[rows], "rmatvec": X1.rmatvec(u),
            "matvec_model_sharded": X1.matvec(v)[rows],
            "rmatvec_model_sharded": X1.rmatvec(u)[cols],
            "frobenius": X1.frobenius_norm()}
    rec["vector_rel"] = {k: rel_err(prods[k], want[k]) for k in prods}
    rec["transpose_exact"] = bool(torch.equal(Xt.data, a.T[rows, cols]))
    rec["tile"] = [mr, nc]
    rec["survivor"] = check_survivor(surv, X1, P1, v, u, sigma_c)
    if rank == 0:
        C1 = CoordinateMatrix.create(ri, ci, va, (M_C, N_C), device=dev)
        rec["coo_rel"] = {"matvec": rel_err(coo["matvec"], C1.matvec(x_c)),
                          "rmatvec": rel_err(coo["rmatvec"],
                                             C1.rmatvec(y_c))}
        rec["coo_local_nnz"] = int(C.values.shape[0])
        rec["survivor"]["coo_rel"] = {
            k: rel_err(surv[f"coo_{k}"], C1.matvec(x_c) if k == "matvec"
                       else C1.rmatvec(y_c)) for k in ("matvec", "rmatvec")}
        del C1
        # gemm at the SUMMA shape against its plain version, timed.
        a_row, b_col = a[rows].contiguous(), b[:, cols].contiguous()
        got = ops.gemm(a_row, b_col, out_dtype=torch.float32)
        plain = _gemm.gemm_plain(a_row, b_col)
        m_, k_, n_ = a_row.shape[0], a_row.shape[1], b_col.shape[1]
        bound_ms, by = bound(4.0 * (m_ * k_ + k_ * n_ + m_ * n_),
                             3 * 2.0 * m_ * k_ * n_, "tf32")
        rec["gemm"] = {
            "max_abs_err": max_abs(got, plain), "rel_err": rel_err(got, plain),
            "ms": time_ms(lambda: ops.gemm(a_row, b_col,
                                           out_dtype=torch.float32)),
            "plain_ms": time_ms(lambda: _gemm.gemm_plain(a_row, b_col)),
            "library_ms": time_ms(lambda: torch.mm(a_row, b_col)),
            "bound_ms": bound_ms, "bound_by": by, "shape": [m_, k_, n_]}
        del a_row, b_col, got, plain
    del a, b, X1, P1, surv
    torch.cuda.empty_cache()
    # Each step again, warm, and the two gathers of SUMMA alone (host
    # clock, synchronized: gloo stages them through the host).
    tile = X.data
    rec["gather_bytes"] = tile.numel() * tile.element_size()
    rec["steps_ms"] = {
        "all_gather model (A's row panel)": _wall_ms(
            lambda: compat.all_gather(tile, mesh, "model"), dev, MESH_REPS),
        "all_gather data (B's column panel)": _wall_ms(
            lambda: compat.all_gather(Y.data, mesh, ("data",)), dev,
            MESH_REPS),
        "multiply": _wall_ms(lambda: X.multiply(Y), dev, MESH_REPS),
        "matvec": _wall_ms(lambda: X.matvec(v), dev, MESH_REPS),
        "rmatvec": _wall_ms(lambda: X.rmatvec(u), dev, MESH_REPS),
        "frobenius": _wall_ms(lambda: X.frobenius_norm(), dev, MESH_REPS),
        "transpose": _wall_ms(lambda: X.transpose(), dev, MESH_REPS),
        "coo matvec": _wall_ms(lambda: C.matvec(x_c), dev, MESH_REPS),
        "coo rmatvec": _wall_ms(lambda: C.rmatvec(y_c), dev, MESH_REPS)}
    return rec


def survivor_path(mesh, a, b, v, u, entries, x_c, y_c, opts, dev) -> dict:
    """Phase 14's survivor path on one rank: the survivor mesh of `mesh`
    once row shard MESH_DROP is dropped (made on every rank), then, on
    each surviving rank, with the counts zeroed just before and read just
    after, BlockMatrix's create, SUMMA product and vector products and
    CoordinateMatrix's create, products and Lanczos SVD there.  A dropped
    rank returns {"member": False}."""
    from repro_torch import api
    from repro_torch.core.distmat import BlockMatrix, CoordinateMatrix
    from repro_torch.kernels import ops
    from repro_torch.train.elastic import survivor_mesh

    surv = survivor_mesh(mesh, MESH_DROP)
    out = {"member": surv.member, "grid": surv.grid.tolist()}
    if not surv.member:
        return out
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    X = BlockMatrix.create(a, mesh=surv)
    P = X.multiply(BlockMatrix.create(b, mesh=surv))
    out.update(mesh=surv, tile=list(X.block_shape), P=P.data,
               matvec=X.matvec(v), rmatvec=X.rmatvec(u),
               index=[surv.index("data"), surv.index("model")])
    C = CoordinateMatrix.create(*entries, (M_C, N_C), mesh=surv)
    out.update(coo_matvec=C.matvec(x_c), coo_rmatvec=C.rmatvec(y_c))
    svd = api.svd(api.SvdRequest(A=C, k=K_SVD, mode="lanczos", options=opts,
                                 device=dev))
    torch.cuda.synchronize(dev)
    out["path_s"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    out.update(sigma=svd.factors[1], svd_info={
        k: svd.info[k] for k in ("op_calls", "restarts", "converged")})
    return out


def check_survivor(surv: dict, X1, P1, v, u, sigma_c: list) -> dict:
    """The survivor path's results against the one-device BlockMatrix
    (product normwise over the surviving ranks' tiles, vector products)
    and phase 9's sigma."""
    from repro_torch import compat

    rec = {"member": surv["member"], "grid": surv["grid"]}
    if not surv["member"]:
        return rec
    mr, nc = surv["tile"]
    r, c = surv["index"]
    rows, cols = slice(r * mr, (r + 1) * mr), slice(c * nc, (c + 1) * nc)
    sq = torch.stack([((surv["P"] - P1[rows, cols]).double() ** 2).sum(),
                      (P1[rows, cols].double() ** 2).sum()])
    sq = compat.psum(sq, surv["mesh"], surv["mesh"].axis_names)
    s = surv["sigma"].double().cpu()
    want_s = torch.tensor(sigma_c, dtype=torch.float64)
    rec.update(tile=surv["tile"], path_s=surv["path_s"],
               launches=surv["launches"],
               product_rel=float(torch.sqrt(sq[0] / sq[1])),
               vector_rel={"matvec": rel_err(surv["matvec"],
                                             X1.matvec(v)[rows]),
                           "rmatvec": rel_err(surv["rmatvec"],
                                              X1.rmatvec(u))},
               svd=dict(surv["svd_info"], sigma_rel=float(
                   ((s - want_s).abs() / want_s).max())))
    return rec


def run_phase14(info: dict, sigma_c: list) -> dict:
    """Phase 14 (see the comment above MESH_SHAPE): the checks on every
    rank's numbers, the prints, and the record."""
    from repro_torch.launch import mesh as lmesh

    t14 = time.perf_counter()
    world = math.prod(MESH_SHAPE)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    ranks = lmesh.spawn(mesh_rank, world, args=(sigma_c,), backend=backend,
                        device="cuda", timeout_s=CLUSTER_TIMEOUT_S,
                        deadline_s=900)
    for r in ranks:
        who = f"mesh rank {r['rank']} {r['grid']}"
        require(r["launches"]["gemm"] == 1
                and sum(r["launches"].values()) == 1,
                f"{who}: launches {r['launches']} (one gemm a rank)")
        require(r["product_rel"] <= MESH_TOL["product"],
                f"{who}: SUMMA product {r['product_rel']:.3e} from the "
                "one-device product")
        bad = {k: e for k, e in r["vector_rel"].items()
               if not e <= MESH_TOL["vector"]}
        require(not bad, f"{who}: vector products off {bad}")
        require(r["transpose_exact"], f"{who}: transpose's tile differs")
        require(r["svd"]["sigma_rel"] <= MESH_TOL["sigma"]
                and r["svd"]["converged"],
                f"{who}: CoordinateMatrix sigma {r['svd']['sigma_rel']:.3e} "
                f"from phase 9's, {r['svd']}")
        sv = r["survivor"]
        require(sv["member"] == (r["grid"][0] != MESH_DROP),
                f"{who}: survivor membership {sv['member']}")
        if not sv["member"]:
            continue
        require(sv["launches"]["gemm"] == 1
                and sum(sv["launches"].values()) == 1,
                f"{who} survivor: launches {sv['launches']} (one gemm)")
        require(sv["product_rel"] <= MESH_TOL["product"],
                f"{who} survivor: SUMMA product {sv['product_rel']:.3e}")
        bad = {k: e for k, e in sv["vector_rel"].items()
               if not e <= MESH_TOL["vector"]}
        require(not bad, f"{who} survivor: vector products off {bad}")
        require(sv["svd"]["sigma_rel"] <= MESH_TOL["sigma"]
                and sv["svd"]["converged"],
                f"{who} survivor: CoordinateMatrix sigma {sv['svd']}")
    head = ranks[0]
    bad = {k: e for k, e in head["survivor"]["coo_rel"].items()
           if not e <= MESH_TOL["vector"]}
    require(not bad, f"mesh survivor: CoordinateMatrix products off {bad}")
    bad = {k: e for k, e in head["coo_rel"].items()
           if not e <= MESH_TOL["vector"]}
    require(not bad, f"mesh: CoordinateMatrix products off {bad}")
    require(head["coo_local_nnz"] * MESH_SHAPE[0] == M_C // BS_S * ELL_S
            * BS_S * BS_S, f"mesh: {head['coo_local_nnz']} entries a rank")
    g = head["gemm"]
    require(g["rel_err"] <= TOL["gemm"],
            f"mesh: gemm at {g['shape']} {g['rel_err']:.3e} from plain")
    rec = {"world": world, "backend": backend, "shape": list(MESH_SHAPE),
           "devices": [r["device"] for r in ranks],
           "path_s": [r["path_s"] for r in ranks],
           "launches": [r["launches"] for r in ranks],
           "product_rel": [r["product_rel"] for r in ranks],
           "vector_rel": head["vector_rel"], "coo_rel": head["coo_rel"],
           "svd": head["svd"], "svd_ms": head["svd_ms"],
           "gather_bytes": head["gather_bytes"],
           "steps_ms": head["steps_ms"], "gemm": g,
           "survivor": {"grid": head["survivor"]["grid"],
                        "ranks": [r["survivor"] for r in ranks]}}
    print(f"[mesh] {world} ranks ({backend}) on a {MESH_SHAPE} mesh, devices "
          f"{rec['devices']}; path {[round(t, 1) for t in rec['path_s']]} s; "
          f"launches (rank 0) {head['launches']}")
    print(f"[mesh] SUMMA {N_BLOCK}^2 @ {N_BLOCK}^2, tiles {head['tile']}: "
          f"{max(rec['product_rel']):.3e} from the one-device product; "
          f"vector products {rec['vector_rel']}; CoordinateMatrix products "
          f"{rec['coo_rel']}, Lanczos k={K_SVD} {head['svd_ms']:.1f} ms, "
          f"{head['svd']['op_calls']} operator calls, sigma "
          f"{head['svd']['sigma_rel']:.3e} from phase 9's")
    for name, ms in head["steps_ms"].items():
        extra = f", {head['gather_bytes']} B a rank" \
            if name.startswith("all_gather") else ""
        print(f"[mesh] {name}: median {ms:.3f} ms (host clock, rank 0)"
              f"{extra}; {info['nvidia_smi']}")
    print(f"[mesh] gemm at the SUMMA shape {g['shape']}: {g['ms']:.3f} ms, "
          f"plain {g['plain_ms']:.3f}, torch.mm {g['library_ms']:.3f}, "
          f"bound {g['bound_ms']:.3f} ({g['bound_by']}, 3xTF32), "
          f"{g['rel_err']:.3e} from plain; {info['nvidia_smi']}")
    sv = head["survivor"]
    print(f"[mesh] survivor of row shard {MESH_DROP}: grid {sv['grid']}, "
          f"tiles {sv['tile']}, path {sv['path_s']:.1f} s (rank 0), "
          f"launches {sv['launches']}; SUMMA "
          f"{sv['product_rel']:.3e} from the one-device product, vector "
          f"products {sv['vector_rel']}, CoordinateMatrix products "
          f"{sv['coo_rel']}, Lanczos sigma {sv['svd']['sigma_rel']:.3e} "
          f"from phase 9's ({sv['svd']['op_calls']} operator calls); "
          f"{info['nvidia_smi']}")
    rec["phase_s"] = time.perf_counter() - t14
    print(f"[mesh] phase 14 in {rec['phase_s']:.1f} s")
    return rec


def smoke(dev: torch.device) -> dict:
    """Phases 2 to 8 on `dev`; returns the numbers to report."""
    from repro_torch import api
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # Columns scaled from 3 down to 1: a condition number near 3 and
    # separated leading singular values; rows of unit scale.
    d = 1.0 + 2.0 * 0.95 ** torch.arange(N, device=dev, dtype=torch.float32)
    A = torch.randn(M, N, generator=gen, device=dev)
    A.mul_(d / math.sqrt(N))
    kernels = check_kernels(A, gen)
    # The slice-2 pieces draw from their own generator, so phases 2-4 see
    # the same numbers as before them.
    gen5 = torch.Generator(device=dev).manual_seed(SEED + 1)
    kernels["fused_grad_multi"] = check_fused_grad_multi(A, gen5)
    A_w = wide_matrix(dev, gen5)
    kernels["randsketch"] = check_randsketch(A_w, gen5)
    kernels["fused_grad"]["wide"] = check_fused_grad_wide(
        A_w, torch.Generator(device=dev).manual_seed(SEED + 2))
    kernels["gemm"]["wide"] = check_gemm_wide(
        A_w, torch.Generator(device=dev).manual_seed(SEED + 9))

    # float64 references, made before the main path's counts are zeroed.
    G64 = gram64(A)
    x_true = torch.randn(N, generator=gen, device=dev)
    z = torch.cat([c @ x_true.double() for _, c in chunks(A)])
    b_quad = (z + 0.5 * torch.randn(M, generator=gen, device=dev,
                                    dtype=torch.float64)).float()
    b_log = torch.where(z + torch.randn(M, generator=gen, device=dev,
                                        dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    f_star = quad_optimum64(A, b_quad, G64)
    del z

    # -- the main path: counts zeroed just before, read just after --------
    ops.reset_launch_counts()
    svd_rec, L0 = run_svd(api, RowMatrix, A, G64)
    rm = RowMatrix.create(A, device=dev)
    solves = []
    for method, iters in (("gra", 200), ("acc_rb", 100)):
        rec, res = run_solve(api, ops, rm, b_quad, loss="quad",
                             method=method, L0=L0, tol=1e-9,
                             max_iters=iters)
        gap = (quad_objective64(A, b_quad, res.x) - f_star) / f_star
        rec["objective_gap"] = gap
        solves.append(rec)
        require(rec["plan"] == {"gra": "fused",
                                "acc_rb": "fused_affine"}[method],
                f"quad {method}: plan {rec['plan']}")
        require(gap <= 1e-5, f"quad {method}: objective gap {gap:.3e}")
        # The stopping rule (a relative step below tol) needs the gradient
        # accurate to f32's rounding: a noisier fused_grad keeps the iterate
        # moving until the cap.
        require(rec["iterations"] < iters,
                f"quad {method}: ran to its cap of {iters} iterations "
                f"without converging")
    rec, res = run_solve(api, ops, rm, b_log, loss="logistic", method="gra",
                         L0=0.25 * L0, tol=1e-9, max_iters=30)
    hist = res.info["history"][:rec["iterations"]].tolist()
    rec["first_last_objective"] = [hist[0], hist[-1]]
    solves.append(rec)
    require(rec["plan"] == "fused", f"logistic gra: plan {rec['plan']}")
    require(all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:]))
            and hist[-1] < hist[0],
            "logistic gra: the objective does not fall monotonically")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # ----------------------------------------------------------------------

    # Where an SVD's time goes, warm (after the counted run): the whole
    # request again, and the n x n eigh alone.
    t0 = time.perf_counter()
    api.svd(api.SvdRequest(A=rm, k=K_SVD, mode="gram", device=dev))
    torch.cuda.synchronize()
    svd_rec["warm_ms"] = (time.perf_counter() - t0) * 1e3
    G32 = G64.float()
    svd_rec["eigh_ms"] = time_ms(lambda: torch.linalg.eigh(G32), reps=3)
    print(f"[svd] warm {svd_rec['warm_ms']:.1f} ms, of which eigh "
          f"{svd_rec['eigh_ms']:.1f} ms")

    for r in solves:
        print(f"[solve] {r['loss']}/{r['method']}: plan {r['plan']}, "
              f"{r['iterations']} iterations, {r['a_passes']} A-passes, "
              f"{r['ms']:.1f} ms, {r['ms_per_iteration']:.3f} ms/iteration"
              + (f", objective gap {r['objective_gap']:.3e}"
                 if "objective_gap" in r else
                 f", objective {r['first_last_objective'][0]:.6e} -> "
                 f"{r['first_last_objective'][1]:.6e}"))
    print(f"[main path] solves and SVD: launches {launches}")
    for name in PATHS["solve_svd"]:
        require(launches[name] > 0, f"{name} never launched on the solve "
                "and SVD path")

    # -- the serving path: counts zeroed just before, read by run_serve
    # just after the grouped server drains, before its checks ------------
    ops.reset_launch_counts()
    serve_rec = run_serve(api, ops, A, A_w, L0, G64,
                          kernels["fused_grad"]["f32"]["quad"]["ms"], gen5)
    serve_launches = serve_rec["launches"]
    # ----------------------------------------------------------------------
    print(f"[main path] serving: launches {serve_launches}")
    for name in PATHS["serve"]:
        require(serve_launches[name] > 0, f"{name} never launched on the "
                "serving path")
    # The randomized SVD again, warm and alone.
    rm_w = RowMatrix.create(A_w, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = api.svd(api.SvdRequest(A=rm_w, k=K_SVD, mode="auto", device=dev))
    torch.cuda.synchronize()
    serve_rec["svd"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[serve] randomized SVD warm {serve_rec['svd']['warm_ms']:.1f} ms, "
          f"{warm.info['a_passes']} A-passes")
    t0 = time.perf_counter()
    api.similarities(api.SimilarityRequest(A=rm, device=dev))
    torch.cuda.synchronize()
    serve_rec["similarity"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[serve] exact DIMSUM of A warm "
          f"{serve_rec['similarity']['warm_ms']:.1f} ms")
    # The dense matrices are done with: phase 6 has the card to itself.
    del A, A_w, rm, rm_w, warm, res
    torch.cuda.empty_cache()

    # -- phase 6 set-up: S on the card, its bf16 and int8 copies, and the
    # phase-2 checks of the sparse kernels on them --------------------------
    t0 = time.perf_counter()
    S = sparse_matrix(dev)
    mats = {"f32": S, "bf16": S.astype_store(torch.bfloat16),
            "int8": S.astype_store(torch.int8)}
    torch.cuda.synchronize()
    print(f"[sparse] S: {M_S} x {N_S}, bs {BS_S}, ell {ELL_S}, block density "
          f"{S.block_density():.4f}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    gen6 = torch.Generator(device=dev).manual_seed(SEED + 4)
    kernels.update(check_sparse_kernels(mats, gen6))
    kernels["fused_grad_bsr_multi"] = check_sparse_multi(
        mats, torch.Generator(device=dev).manual_seed(SEED + 6))
    del mats["bf16"]
    torch.cuda.empty_cache()
    # float64 references, made before the path's counts are zeroed.
    a, a_i8 = S._local(), mats["int8"]._local()
    x_true = torch.randn(N_S, 1, generator=gen6, device=dev,
                         dtype=torch.float64) / math.sqrt(ELL_S * BS_S)
    z = apply64(a, x_true)[:, 0]
    b_quad = (z + 0.5 * torch.randn(M_S, generator=gen6, device=dev,
                                    dtype=torch.float64)).float()
    b_log = torch.where(z + torch.randn(M_S, generator=gen6, device=dev,
                                        dtype=torch.float64) > 0,
                        1.0, -1.0).float()
    refs = {"b_quad": b_quad, "b_log": b_log, "atb": {
        key: float(torch.linalg.vector_norm(rapply64(bell, b_quad[:, None])))
        for key, bell in (("f32", a), ("int8", a_i8))}}
    del z

    # -- the sparse path: counts zeroed just before, read just after -------
    ops.reset_launch_counts()
    sparse_rec = run_sparse(api, ops, S, mats["int8"], refs)
    torch.cuda.synchronize()
    sparse_launches = ops.launch_counts()
    # ----------------------------------------------------------------------
    print(f"[main path] sparse: launches {sparse_launches}")
    for name in PATHS["sparse"]:
        require(sparse_launches[name] > 0, f"{name} never launched on the "
                "sparse path")
    t0 = time.perf_counter()
    api.svd(api.SvdRequest(A=S, k=K_SVD, device=dev))
    torch.cuda.synchronize()
    sparse_rec["svd"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[sparse] Lanczos SVD warm {sparse_rec['svd']['warm_ms']:.1f} ms")
    # Phase 6's copies and references are done with.
    del mats, a, a_i8, refs, b_quad, b_log, x_true
    torch.cuda.empty_cache()

    # -- phase 7 set-up: S_sim, its densified RowMatrix and the float64
    # references, made before the path's counts are zeroed ----------------
    t0 = time.perf_counter()
    S_sim, pairs = similarity_matrix(dev)
    refs7 = similarity_refs64(S_sim, pairs)
    dense_sim = RowMatrix(rows=S_sim._dense_columns(0, N_SIM), n_rows=M_SIM)
    torch.cuda.synchronize()
    print(f"[sparse serve] S_sim: {M_SIM} x {N_SIM}, bs {BS_S}, ell {ELL_S}, "
          f"{PLANTED} planted pairs (float64 cosine mean "
          f"{float(refs7['cos'].mean()):.4f}), built in "
          f"{time.perf_counter() - t0:.1f} s")
    refs7["cos64"] = cosines64(dense_sim.rows)
    L0_S = sparse_rec["svd"]["sigma_1"] ** 2
    B_quad7, B_log7 = sparse_serve_targets(
        S, torch.Generator(device=dev).manual_seed(SEED + 7))

    # -- the sparse serving path: counts zeroed just before, read just after
    ops.reset_launch_counts()
    t7 = time.perf_counter()
    served = serve_sparse(api, S, S_sim, dense_sim, B_quad7, B_log7, L0_S)
    torch.cuda.synchronize()
    serve7_launches = ops.launch_counts()
    # ----------------------------------------------------------------------
    path_s = time.perf_counter() - t7
    print(f"[main path] sparse serving: launches {serve7_launches}, "
          f"{path_s:.1f} s")
    for name in PATHS["sparse_serve"]:
        require(serve7_launches[name] > 0, f"{name} never launched on the "
                "sparse serving path")
    require(serve7_launches["fused_grad_bsr_multi"]
            == served["server"].stats["a_passes"],
            f"sparse serve: {serve7_launches['fused_grad_bsr_multi']} "
            f"fused_grad_bsr_multi launches != "
            f"{served['server'].stats['a_passes']} server A-passes")
    require(serve7_launches["fused_grad_multi"] == 0
            and serve7_launches["fused_grad_bsr"] == 0,
            "sparse serve: another fused kernel launched inside group steps")
    serve7_rec = check_sparse_serve(
        api, ops, served, S, B_quad7, B_log7, pairs, refs7, L0_S,
        kernels["fused_grad_bsr"]["f32"]["quad"]["ms"])
    serve7_rec["path_s"] = path_s
    serve7_rec["launches"] = serve7_launches
    del served, B_quad7, B_log7
    # The kernels at phase 7's widths against their plain versions.
    for name, cases in check_wide_kernels(S, S_sim, dense_sim).items():
        kernels[name].update(cases)
    del dense_sim
    torch.cuda.empty_cache()
    # The sampled DIMSUM again, warm and alone, and S_sim's Gram alone.
    t0 = time.perf_counter()
    api.similarities(api.SimilarityRequest(A=S_sim, threshold=SIM_THRESHOLD,
                                           device=dev))
    torch.cuda.synchronize()
    serve7_rec["dimsum"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    S_sim.gram()
    torch.cuda.synchronize()
    serve7_rec["dimsum"]["gram_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[sparse serve] sampled DIMSUM warm "
          f"{serve7_rec['dimsum']['warm_ms']:.1f} ms, S_sim's Gram "
          f"{serve7_rec['dimsum']['gram_ms']:.1f} ms")
    # The sparse matrices are done with: phase 9 has the card to itself.
    del S, S_sim, refs7, pairs
    torch.cuda.empty_cache()

    # -- phase 9: the front doors; run_phase9 zeroes and reads the counts
    # around each of its paths ------------------------------------------------
    front, fd_paths, kernels["gemm"]["block"] = run_phase9(
        api, ops, dev, torch.tensor(svd_rec["sigma"], device=dev))
    torch.cuda.empty_cache()

    # -- phase 8: LM serving; run_lm zeroes and reads the counts around each
    # model's generate ------------------------------------------------------
    lm = run_lm(dev)
    by_path = {"solve_svd": launches, "serve": serve_launches,
               "sparse": sparse_launches, "sparse_serve": serve7_launches,
               **fd_paths, **{f"lm:{arch}": rec["launches"]
                  for arch, rec in lm["models"].items()}}

    rows = []
    for name, by_dtype in kernels.items():
        f32 = {"fused_grad": lambda r: r["quad"],
               "fused_grad_bsr": lambda r: r["quad"],
               "fused_grad_multi": lambda r: dict(
                   r[SLOTS], max_abs_err=r[SLOTS]["quad"]["max_abs_err"]),
               "fused_grad_bsr_multi": lambda r: dict(
                   r[SLOTS], max_abs_err=r[SLOTS]["quad"]["max_abs_err"])
               }.get(name, lambda r: r)(by_dtype["f32"])
        shape = {"gemm": [M, N, K_GEMM], "fused_grad_multi": [M, N, SLOTS],
                 "randsketch": [M_W, N_W, R_SKETCH],
                 "bsr_matvec": [M_S, N_S, 1], "bsr_matmul": [M_S, N_S, K_U],
                 "bsr_rmatmul": [M_S, N_S, 1],
                 "fused_grad_bsr": [M_S, N_S],
                 "fused_grad_bsr_multi": [M_S, N_S, SLOTS]}.get(name, [M, N])
        path = next(p for p, names in PATHS.items() if name in names)
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": by_path[path][name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "shape": shape, "dtype": "f32", "checks": by_dtype})
    for name, recs in lm["kernels"].items():
        main = recs["bf16" if name == "flash_attention" else "f32"]
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": recs["launches"],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"],
            "dtype": "bf16" if name == "flash_attention" else "f32",
            **({"variant": main["variant"],
                "variant_launches": recs["variant_launches"]}
               if name == "flash_attention" else {}),
            "checks": recs})
    # -- phase 10: the planner (after every path, with the kernels' rows) --
    planner_rec = run_phase10(api, ops, dev, rows, kernels, lm["kernels"],
                              svd_rec["sigma"][0] ** 2)
    return {"kernels": rows, "svd": svd_rec, "solves": solves,
            "serve": serve_rec, "sparse": sparse_rec,
            "sparse_serve": serve7_rec, "front_door": front,
            "lm": lm["models"], "planner": planner_rec,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Phase 10 sweeps and calibrates into a fresh cache, so every run
    # starts from the built-in model and leaves nothing for the next.
    with tempfile.TemporaryDirectory() as cache:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
            Path(cache) / "autotune.json")
        return run()


def run() -> int:
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    info = card()
    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report()
    for r in ptxas:
        print(f"[ptxas] {r['kernel']}: {r['registers']} registers, "
              f"{r['spill_store_bytes']} bytes spill stores, "
              f"{r['spill_load_bytes']} bytes spill loads"
              + (", wgmma serialized" if r["wgmma_serialized"] else ""))
    flash = [r for r in ptxas if "flash_fwd" in r["kernel"]]
    require(len(flash) == 2 * 4 and all(
        r["spill_store_bytes"] == r["spill_load_bytes"] == 0
        and not r["wgmma_serialized"] for r in flash),
        f"flash_attention (both variants, D = 32, 64, 128, 192) spills or "
        f"serializes its wgmmas: {flash}")
    for source, count in (("randsketch.cu", 3), ("tsgram.cu", 5),
                          ("bsr_spmm.cu", 15), ("bsr_rmatmul.cu", 28),
                          ("gemm.cu", 18), ("selective_scan.cu", 4)):
        rows = [r for r in ptxas if r["source"] == source]
        require(len(rows) >= count and all(
            r["spill_store_bytes"] == r["spill_load_bytes"] == 0
            and not r["wgmma_serialized"] for r in rows),
            f"{source}'s kernels spill or serialize their wgmmas: {rows}")

    summary = smoke(dev)
    summary["ptxas"] = ptxas
    # -- phase 11: the cluster path, in process groups of its own, after
    # every earlier matrix is freed; each rank zeroes and reads its counts
    # around the path --------------------------------------------------------
    torch.cuda.empty_cache()
    summary["cluster"] = run_phase11(info)
    # -- phase 12: fault-tolerant solves on A and S, after phase 11's
    # groups are gone; each case zeroes and reads its counts -------------
    torch.cuda.empty_cache()
    summary["elastic"] = run_phase12(info)
    for row in summary["kernels"]:
        row["launches_by_path"]["cluster"] = \
            summary["cluster"]["launches"][0].get(row["name"], 0)
        row["launches_by_path"]["elastic"] = \
            summary["elastic"]["launches"].get(row["name"], 0)
    # -- phase 13: fp8 storage on the main path (A redrawn, cast on the
    # card to each fp8 type); each type's path zeroes and reads the counts,
    # and rows 1-5 gain their e4m3 and e5m2 readings --------------------------
    torch.cuda.empty_cache()
    summary["fp8"] = run_phase13(summary["kernels"], info, dev)
    # -- phase 14: BlockMatrix and CoordinateMatrix on a (2, 2) mesh, in a
    # process group of its own; each rank zeroes and reads its counts
    # around the path ---------------------------------------------------------
    torch.cuda.empty_cache()
    summary["mesh"] = run_phase14(
        info, summary["front_door"]["coordinate"]["coordinate"]["sigma"])
    survivors = [r for r in summary["mesh"]["survivor"]["ranks"]
                 if r["member"]]
    for row in summary["kernels"]:
        row["launches_by_path"]["mesh"] = \
            summary["mesh"]["launches"][0].get(row["name"], 0)
        row["launches_by_path"]["mesh_survivor"] = \
            survivors[0]["launches"].get(row["name"], 0)
        if row["name"] == "gemm":
            row["checks"]["summa"] = summary["mesh"]["gemm"]
    for name in PATHS["mesh"]:
        require(all(c[name] > 0 for c in summary["mesh"]["launches"]),
                f"{name} never launched on the mesh path")
    for name in PATHS["mesh_survivor"]:
        require(all(r["launches"][name] > 0 for r in survivors),
                f"{name} never launched on the survivor mesh path")
    print(json.dumps({"svd": summary["svd"], "solves": summary["solves"],
                      "serve": summary["serve"],
                      "sparse": summary["sparse"],
                      "sparse_serve": summary["sparse_serve"],
                      "front_door": summary["front_door"],
                      "lm": summary["lm"], "planner": summary["planner"],
                      "cluster": summary["cluster"],
                      "elastic": summary["elastic"],
                      "fp8": summary["fp8"], "mesh": summary["mesh"],
                      "ptxas": summary["ptxas"],
                      "peak_memory_gb": summary["peak_memory_gb"]}))
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
