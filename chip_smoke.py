#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quantizedmha_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line; any failure exits non-zero with no
result line:

  build    compile every CUDA source under quantizedmha_tpu_torch/csrc/
           (one nvcc each, in parallel) and report the card, each kernel's
           registers and spills and each source's serialized wgmma
           (flash_int8_bf16p, flash_int8_int8p: the INT8 flash bf16-P and
           int8-P kernels').
  kernels  hold each kernel against its plain PyTorch version on the card
           at the main paths' shapes, every element within its stated
           tolerance (err_over_tol <= 1), then on small cases off the main
           paths and on the two mixed-cache compositions (INT8 and INT4
           partials merged by lse) against their plain compositions; the
           backward's two kernels at the training step's attention shape
           (bf16, and f32 in each entry's "train_f32") and on 21 small cases
           (10 at d=256, 5 of them in f32) and 2 f32 d=256 cases on a grid
           that makes the raw dots exact (FLASH_BWD_GRID: a bf16-rounded P
           or dS shows there), each pair launched twice (the same bits
           both times, or the check fails), and so is every INT8 flash
           launch (the three numerics modes at their main shapes: int8 P
           at serve's 256-token, serve_w4's 512-token and the prefill
           bench's 2048-token prefill, bf16 P with l over the bf16 P'
           (mode 1) and over the f32 P' (mode 2) at solve's shape; every
           FLASH_COVERAGE case, and FLASH_ONE_SIDED's, where the two bf16-P
           modes' l differ by more than 10x their tolerance), every float
           flash launch (the
           f32 route's split planes filled with NaN before its first,
           so that a plane element left unwritten shows; its own
           coverage cases and FLASH_FWD_PIECES, built so that a dropped
           third bf16 piece shows), every bf16 paged prefill launch (INT8 and INT4,
           tensor cores), every paged decode launch (INT8 and INT4:
           split page walks merged by lse) and every w4_matmul launch
           (the four fused 8B matmuls at R = 8, 1, 32 and 64),
           the decode at serve's, serve_flash's and serve_mixed's shapes
           and for MQA, each reporting its splits;
           kernel / plain / library times (CUDA events) and the least time
           the card could take (bound). Rows 3, 5 and 10 also at head_dim
           256, serve_hybrid's Gemma-2 shapes (each entry's "gemma2"), and
           row 1 (int8 P) at serve_hf's Gemma-2 shapes ("full": 2048
           tokens, "sliding": 8192 under the 4096 window, "f32": f32 q),
           mode 1 at the same three (block_kv 512, the transposed route's)
           and mode 2 at "full" (block_kv 1024, the standard route's),
           rows 6 and 7 at train_gemma2's ("full": 8192 tokens causal,
           "sliding": under the 4096 window, both softcap 50 with a dlse;
           SDPA's bf16 backward beside them) and in f32 at
           train_gemma2_f32's ("full_f32", "sliding_f32"; SDPA's f32
           backward beside them), rows 5, 10 and 11 in f32 at
           serve_gemma2_f32's ("full_f32", "sliding_f32": row 5 at 2048
           tokens causal and at 8192 under the 4096 window, rows 10-11
           with f32 q at a 2048-row chunk at 4096; SDPA in f32 beside
           them),
           the d=256 coverage cases (D256_*: rows 3, 5, 10, 11 and 12,
           rows 5, 10 and 11 in f32 too, some with the slots behind the
           window on a scrap page of 0x7f bytes and scale 1e30); row 10 at serve_spec's verify shape and
           rows 11 and 12 at serve_hybrid_mixed's (gemma2 "verify" and
           "full"), and VERIFY_COVERAGE (row 10 at verify's shape: 4 or 8
           sequences of 2, 5 or 9 rows, each at its own offset, d=128 and
           256, window 4096, softcap 50).
  solve    the reference ABI at N=8192, d_model=1024, h=32 in float32:
           solve(kernel="fa_int8"), then the float rungs "fa", "fa_bf16"
           and "unfused", and "fa" again at d_model=4096, h=16 (head_dim
           256, "fa_d256"): time, relative RMS error against the float
           golden with each rung's limit, and the constant-input gate
           (all-ones -> exactly 1.0).
  int8_modes  each INT8 numerics mode through the port's public entry
           points (INT8_MODES), the quantize prepass and the routing
           included: flash_attention_int8 at Gemma-2-9B's attention width
           (16 q / 8 kv heads of 256, softcap 50, bf16) and 2048 tokens with
           transposed=True (mode 1) and with summode="vpu" too (mode 2), at
           8192 tokens under the 4096 window (mode 1), and on the standard
           route with pv_dtype="bf16" (mode 2); flash_attention_int8_t at
           the reference workload (N=8192, h=32, d=32, f32) with summode
           "mxu" and "vpu". Gates: exactly one launch of the mode's kernel
           and none of the others', the output within flash_tolerances of
           the plain version, relative RMS error against the float golden
           <= 3%, all-ones inputs giving ones within 1e-6. Prints ms.
  harness  the reference driver, `harness.cli.run(["--kernel", "all",
           ...])` at the same workload with a temporary cache and JSON
           report: every rung checked against the float golden, then
           timed by CUDA events. Gates: rc 0, no rung error, every check
           passing, every timed rung's ms > 0, the exact launches of each
           rung's kernel, every share of the speed of light <= 100%, and
           each rung's ms within 0.8-1.25x of the solve phase's (two timers
           of the same work). Runs after solve (--phases adds it).
  serve    Llama-3-8B width and depth (32 layers), random INT8 (w8a16)
           weights with a bf16 lm_head, flash_int8 prefill and paged INT8
           decode through the continuous-batching engine: 8 requests of
           256-token prompts, 32 new tokens each, greedy. Then the serving
           benchmark's prefill (harness/serving_bench.run_prefill_bench):
           2048 random tokens through prefill_at, its ms, TFLOP/s and share
           of the tensor cores' bf16 speed of light (<= 100%), every layer's
           attention through the int8-P kernel (exact launches).
  serve_w8a8  the serve phase's model and traffic with
           weight_quant_mode="w8a8" (serve's INT8 params, or the same seed's):
           each activation row quantized to int8, int8 x int8 products on
           torch._int_mm. First every W8A8_MATMULS shape (rows 1-2048 against
           Llama-3-8B's (in, out) pairs and an INT8 lm_head's), f32 and bf16
           x with a zero row and a row of rounding ties, bit for bit: the row
           quantization against the CPU's, the int32 product against the
           exact plain one, the output; the product's times beside w8a16's
           and a row-major weight's. Gates: exact launches of rows 1 and 3,
           7 w8a8 products a layer a forward, every token, pools drained,
           the last-token logits within 0.25 std of the reference-attention
           model; then the 2048-token prefill bench in w8a8 beside serve's
           w8a16 figure, and w8a8's logits against w8a16's (printed).
  serve_w4 "llama3-8b-shape-int4-lmh8": the same model's random weights
           quantized to INT4 (group 128, halves packing, wq|wk|wv and
           w_gate|w_up fused) with an int8 lm_head, served by the serving
           benchmark (harness/serving_bench.run_decode_bench) at batch 1,
           8 and 32: 512-token prompts, 64 new tokens each, decode chunk
           16. Every decode matmul goes through the w4_matmul kernel
           (exactly 4 launches a layer a decode step; 512-row prefills
           take the dequantize-then-matmul lowering). A 64-token prefill
           is held against the dequantized weights as plain bf16 tensors.
           With --profile, full-batch decode chunks at batch 8 and 32 run
           under torch.profiler.
  serve_flash  Llama-3-8B as configured (attention_impl="flash", random
           bf16 weights, 32 layers) through the engine with the default
           buckets (128-2048), page 128, prefix caching and interleaved
           prefill: prompts of 256, 700, 1500 and 2000 tokens (float flash
           prefill), 5000 and 7900 (chunked prefill through the paged INT8
           cache, one chunk per engine step), then two prompts sharing the
           7900-token prompt's first 4096 tokens (prefix hits: only their
           suffixes prefill); 32 new tokens each, greedy. Then eight fresh
           2000-token prompts, 72 new tokens each: the engine steps that
           decode all eight for a whole chunk time decode at batch 8.
           Gates: exact launch counts, 2 hits reusing 8192 tokens, the
           2000-token and the chunked 5000-token prefills' last logits
           within 0.25 std of the float attention golden.
  serve_mixed  the same model served from the mixed INT8-sink / INT4-bulk
           paged cache (mixed_kv: boundary 256, 32 INT8 and 512 INT4 pages,
           4 scale sub-tiles a page): prompts of 240, 1000 and 2000 tokens
           (bucketed, written 2 INT8 pages + the rest INT4; the 240-token
           one crosses the boundary while it decodes), 5000 and 7900
           (chunked and interleaved: every chunk runs the INT8 and the INT4
           paged prefill), 32 new tokens each; then eight 2000-token
           prompts, 72 new tokens each, time decode at batch 8 (every step
           runs the INT8 and the INT4 paged decode). Gates: exact launch
           counts, every token, both pools drained, the 5000-token prompt's
           last logits through a fresh mixed cache within 0.25 std of the
           golden whose float attention reads K/V through the same INT8 /
           INT4 quantization; their distance from the float golden, and the
           plain INT8 cache's, printed beside it.
  serve_hybrid  LlamaConfig.gemma2_9b() as configured (42 layers, head_dim
           256, a 4096-token window on even layers, softcaps 50 and 30,
           attention_impl="flash", random bf16 weights) through the engine
           with hybrid_kv (a page pool for the full layers, one for the
           sliding layers: SERVE_HYBRID's sizes), prefix caching and
           interleaved prefill: prompts of 300 and 1800 tokens (bucketed,
           row 5), 6000 (three chunks, row 10; its decode starts past the
           window), 64 new tokens each, then a prompt sharing the long
           one's first 46 pages (a prefix hit, one chunk of its suffix).
           Gates: the three non-hit streams equal a shared-pool engine's
           (hybrid_kv=False) on the card and the hit's has its length,
           exact launches of rows 3, 5 and 10, pages trimmed, each
           sequence's live sliding pages <= 34 while the full pool holds
           all of the long prompt's, every pool drained, the long prompt's
           last logits (chunked through fresh hybrid pools) within 0.25 std
           of the float golden. Prints TTFT, decode ms a step, peak memory
           and the long sequence's KV bytes against one shared pool's.
  serve_hybrid_mixed  Gemma-2-9B as serve_hybrid configures it, with
           hybrid_kv and mixed_kv (boundary 256: the full layers' pool the
           INT8 / INT4 pair, the sliding layers' plain INT8), interleaved
           prefill, no prefix cache: prompts of 100, 300 and 1800 tokens
           (bucketed) and 6000 (three chunks: rows 10 and 11), 64 new
           tokens each in decode chunks of 8 (rows 3 and 12). Gates: exact
           launches, pages trimmed, the INT4 pool holding the long
           prompt's bulk, every pool drained, each request's logits at its
           last decode step within 0.25 std of the golden whose float
           attention reads K/V through the pools' INT8 / INT4 quantization
           (scales fitted as prefill and decode fit them); the float
           golden's distance printed. Prints TTFT, decode ms a step and the
           long sequence's KV bytes.
  serve_gemma2_f32  LlamaConfig.gemma2_9b() with dtype float32 at full
           width and depth (42 layers, 10.16e9 parameters, 40.6 GB, random
           weights from a seeded generator), serve_hybrid's traffic with
           32 new tokens each (SERVE_GEMMA2_F32), twice: (a) hybrid INT8
           pools with the prefix hit (rows 3, 5, 10 in f32 at d=256), then
           the same traffic through a shared pool; (b) hybrid pools with
           the mixed INT8 / INT4 full group (rows 11, 12 too; no prefix
           cache). Gates: exact launches of each run (no bf16 kernel), the
           non-hit streams equal the shared pool's, the hit's length and
           prefix counters, pages trimmed, every pool drained, the INT4
           pool holding the long prompt's bulk, each request's last decode
           logits within 2^-6 std of the golden whose float attention reads
           K/V through the same quantization (the derivation at
           SERVE_GEMMA2_F32). Prints weights' GB, peak memory, TTFT,
           decode ms a step and the long sequence's KV bytes of each run.
  serve_spec  speculative decoding (SpecDecodeEngine) on Gemma-2-9B with
           hybrid_kv, the draft its first two layers (pattern (4096, None),
           views of its weights): prompts of 300, 1800, 5000 and 4200
           tokens, 48 new tokens each, batch 4: (a) greedy, k = 4; (b) the
           target as its own draft; (c) adaptive k from 2 to 6; (d)
           temperature 0.8, top-p 0.95. Gates: verify_step's logits
           within 0.25 std of the golden whose float attention reads K/V
           through the pools' INT8 quantization, on a shared 1800-token
           prefix (decode_step's too) and on a full batch of (b) (the long
           contexts, trimmed); the max |verify_step - decode_step| logit
           delta on that prefix at most 8 bf16 ulps of the golden's largest
           logit; (a)'s streams equal the plain hybrid engine's up to a
           first divergence, allowed only where that engine's top-2 logit
           gap is below twice the delta; every rejection of (b) at a top-2
           gap (verify's logits) below twice the delta, and (b)'s
           acceptance at least what rejecting at every near-tie (the plain
           engine's top-2 gap within one bf16 ulp) would leave; three
           planted verify faults (wrong slot, stale page, wrong offset),
           each run through (b) and the prefix check, must each fail one of
           those gates; exact launches (row 10 at verify's shape, rows 3
           and 5 on both models); every pool of target and draft drained.
           Prints acceptance, tokens/s, target forwards a token and the
           pages rollbacks freed.
  serve_hf a checkpoint in HF's layout written into a temporary directory
           (SERVE_HF: LlamaConfig.gemma2_9b()'s widths, vocabulary 256000,
           head_dim 256, softcaps 50 / 30, depth cut to 4 layers, sliding
           and full in turn; bf16 from seeded generators, HF's tensor names
           and rotate-half q/k rows, tied embeddings, three files and an
           index, written by the port's safetensors writer), read by
           models.hf_loader.config_from_hf and load_llama(quantize=True)
           (w8a16) and served with attention_impl="flash_int8" through the
           engine with hybrid_kv and interleaved prefill: prompts of 300,
           1200 and 2000 tokens (bucketed: row 1, int8 P, at d=256 with S =
           512 and 2048) and 5200 (three chunks: row 10, the 4096 window
           biting on the sliding layers), 16 new tokens each, after a
           warm-up whose launches are counted apart. Gates: (a) the loaded
           config equals the preset cut to 4 layers in every field; (b)
           every INT8 projection's values and scales equal quantize_weight
           of the tensor as written (unpermuted, transposed), norms and the
           embedding (and the tied lm_head) the written bf16, bit for bit;
           (c) each prompt's last logits from the engine within 0.25 std of
           the golden: the same loaded params with the float reference
           attention, the prompt unpadded; (d) exact launches of rows 1, 10
           and 3 (row 1: layers x bucketed prefills); (e) the same traffic
           run twice gives the same streams; (f) a config.json with head_dim
           96 is refused by load_llama on the card with the head-dim rule's
           message. Prints the write, read-and-quantize and serve times,
           TTFT, decode ms a step, peak memory and the long sequence's KV
           bytes.
  train    sgd_train_step of LlamaConfig.llama3_8b() as configured (bf16,
           attention_impl="flash", 32 layers, random weights from seed 0)
           on one batch of 2048 random tokens, 4 steps at lr 0.5: every
           forward through the float flash kernel, every backward through
           the dK/dV and dQ kernels of flash_bwd.cu. Gates: exactly 32
           launches a step of each, finite loss and weights, step 0's loss
           equal to loss_fn without grad, the loss falling every step; then
           at the same width cut to 2 layers, every leaf's gradient of one
           step within 2^-4 of its largest entry of the same step through
           the float golden (attention_impl="reference"). Prints the losses,
           ms a step, tokens/s, the share of weights changed, peak memory.
  train_gemma2  sgd_train_step of LlamaConfig.gemma2_9b() at full width
           (hidden 3584, 16 q / 8 kv heads of 256, MLP 14336, vocabulary
           256000; bf16, attention_impl="flash", random weights from seed
           0), depth cut from 42 to 8 layers (4 sliding, 4 full: the memory
           reckoning at TRAIN_GEMMA2), on one batch of 8192 random tokens
           (Gemma-2's context; the 4096 window bites on the even layers), 4
           steps at train's lr: every forward through row 5 and every
           backward through rows 6 and 7 at head_dim 256. Gates as train's:
           exact launches (8 a step of each of rows 5-7, none of the f32 or
           INT8 kernels), finite loss and weights, step 0's loss within 1e-5
           of loss_fn without grad, the loss falling every step; then the
           same width at 2 layers (one sliding, one full) on 5120 tokens,
           every leaf's gradient within 2^-4 of its largest entry of the
           float golden's (attention_impl="reference"). Prints the losses,
           ms a step, tokens/s after the first step, peak memory.
  train_gemma2_f32  the same in f32 (dtype=torch.float32), depth cut to 4
           layers (2 sliding, 2 full: the memory reckoning at
           TRAIN_GEMMA2_F32): every forward through row 5's f32 route and
           every backward through rows 6 and 7's f32 kernels at head_dim 256.
           Gates: exact launches (4 a step of each of rows 5-7, none of the
           bf16 forward or INT8 kernels), every backward launch built at
           head_dim 256 with the bf16 flag 0, finite loss and weights, step
           0's loss within 1e-6 of loss_fn without grad, the loss falling
           every step; then 2 layers on 5120 tokens, every leaf's gradient
           within 2^-10 of its largest entry of the float golden's. Prints
           the losses, ms a step, tokens/s after the first step, the
           weights' GB, peak memory and the card.
  train_parallel  training across ranks: one spawn of 4 ranks on GPU 0
           joined by gloo (4 processes time-share the card and every
           collective crosses the host: not multi-GPU speeds), three jobs,
           the unsharded side computed first and freed. (a) DP x TP: dp 2 x
           tp 2 (a (2,) x (2,) hybrid mesh) at Llama-3-8B's width, depth cut
           to 4 layers, bf16, attention_impl="flash", 2048 tokens a dp rank,
           3 steps at lr 0.5; the parent saves the initial weights with
           utils.checkpoint.CheckpointManager and each rank restore_sharded's
           its shard. Gates: step 1's loss within 2e-3 relative of the
           unsharded sgd_train_step's on the same global batch (the bf16
           bound of tests/test_torch_train.py), a later step's within that
           plus 2^-4 of the unsharded loss's change over the steps before
           it; the same losses on every rank, falling; every leaf's first-step gradient shard within 2^-4 of
           its largest entry of the unsharded gradient's slice; weights
           finite; exact launches (rows 5, 6, 7: 4 a step); the audit exact:
           the records of every step equal parallel.distributed.
           train_step_collectives (4L + 3 all-reduces on tp, two on dp), tp
           on "ici" and dp on "dcn" at granule 2, bytes too. (b) PP: pp 4,
           8 layers (2 a stage), 4 x 512 tokens in 4 microbatches: every
           rank's logits the same, within 0.25 std of the unsharded
           forward's; each stage's layer gradients within 2^-4 of the
           unsharded loss's; exact launches. (c) CP: cp 4 at Llama-3-8B's
           attention width (Hq 32, Hkv 8, d 128, bf16, causal, 32768 tokens,
           8192 a rank): ring_attention, ring_attention_int8 (block_kv 512)
           and context_parallel_attention (q the last 2048 rows), forward and
           backward: dq, dk, dv within ring_grad_tolerances of the flash
           kernel's backward over the unsharded sequence (the INT8 ring's at
           the shards' dequantized K/V), and the INT8 ring's gradients equal
           to ring_attention's at the dequantized K/V bit for bit; exact
           launches. Five planted faults (the dp gradient summed, not
           averaged; copy_to_group without its backward all-reduce; a stage
           dropping microbatch 0's gradient; the ring's gradient rotation
           sent right; the INT8 straight-through backward at the raw K/V)
           must each fail a gate. Rows 5, 6 and 7 at a tp rank's attention
           (16 q / 4 kv heads, 2048 tokens) and a ring step (8192 x 8192 at
           offsets, with an lse cotangent), row 1 at an INT8 ring step, each
           within its plain version's tolerance (the kernels line's
           "train_parallel_rank"). Prints ms a step a rank, peak memory a
           rank and the collectives' host seconds.
  parallel ring and context parallelism at Llama-3-8B's attention width
           (B=1, Hq=32, Hkv=8, d=128, bf16, causal, 32768 tokens): 4 ranks'
           steps driven in one process in ring order (simulate_ring, no
           process group): ring_attention (row 5 a step), at window 4096
           too, ring_attention_int8 (block_kv 512, row 1; the shards'
           payloads and scales equal the unsharded ones bit for bit),
           context_parallel_attention with q the last 2048 rows; the INT8
           ring at the reference workload (N=8192, h=32, d=32, f32, causal
           and not: row 2). Each partial finite and within its kernel
           tolerance, each ring within its steps' tolerances merged of the
           plain ring, and of the kernel over the unsharded sequence; a
           planted fault (kv offsets from rank idx + step) must fail. Then
           the public entries and head_parallel_attention (both kernels) on a
           one-rank NCCL group, bit for bit the unsharded kernel; the group
           is destroyed. The rotation over NCCL between cards is not checked
           on one card.
  serve_tp tensor parallelism on the one card: ranks are processes sharing
           GPU 0, joined by gloo through a FileStore in a temporary directory
           (N processes time-share the card and every collective crosses the
           host: not multi-GPU speeds). The unsharded side first, on the same
           weights (serve's seed), then freed: the Engine's streams, prefill
           logits and top-2 gaps, and the reference-attention golden. (a)
           TPEngine at tp=4 on serve's model (Llama-3-8B, 32 layers, w8a16,
           each rank making its shard layer by layer: _serve_params_lazy) and
           traffic. Gates: every rank's streams bit-equal; the 8 prefill
           logits within 0.25 std of the golden and of the unsharded engine's;
           the streams equal the unsharded engine's up to a first divergence,
           allowed only where its top-2 gap is below twice the largest logit
           delta; exact launches of rows 1 and 3 a rank; the audit: 2
           all-reduces a layer a forward, nothing else, bytes 2 x layers x
           rows x hidden x 2; each rank's parameter bytes equal to the plan
           (meta tensors), its pages at 2 kv heads; pools drained; rows 1 and
           3 held against their plain versions at the rank's shapes (Hq 8, Hkv
           2). The same at 2 layers clean and with a planted fault (wo's rows
           of two heads swapped: a head order unlike wq's), which must fail a
           gate. (b) TPSpecDecodeEngine at tp=4, the draft the first two
           layers, k = 4, 4 requests, greedy, then temperature 0.8 / top-p
           0.95: streams bit-equal across ranks, row 10 launched at verify's
           shape on every rank (and held to its plain version there), pools of
           both drained, acceptance printed. (c) TPEngine at tp=8 (8
           processes) on Llama-3-70B's layer dims at 2 layers (f32, MLP 2048,
           vocabulary 512): row 4 launched at 8 q / 1 kv head and held to its
           plain version, streams equal across ranks and to the unsharded
           engine's, bytes as planned. Prints TTFT, decode ms a step, peak
           memory a rank, the audit and the all-reduces' share of the run.
  serve_cp context-parallel prefill in the engine (EngineConfig.cp_mesh)
           over 4 such ranks, parameters replicated (serve's INT8 weights,
           made layer by layer): a 7900- and a 2000-token prompt, buckets
           (2048, 8192), 16 new tokens each, greedy. Gates: the last logits
           within 0.25 std of the unsharded prefill_at's (float flash) and of
           the golden; the gathered K/V of layers 0 (one bf16 ulp) and 31
           (0.25 std) against prefill_at's; streams bit-equal across ranks;
           exact launches (row 5: 4 ring steps x 32 layers a prefill; row 3
           the decodes); the audit: 2 collective-permutes a rotating ring
           step and one all-gather a prefill, nothing else; each rank's first
           ring step held to row 5's plain version; a planted fault
           (rank-local RoPE positions) must move the logits past 0.25 std.
  faults   each line of PLANTED_FAULTS planted in a copy of csrc/, the
           kernel sources that the changed file is part of (flash_fwd.cu,
           paged_prefill.cu, paged_decode.cu, flash_bwd.cu, w4_matmul.cu,
           flash_int8_fwd.cu, their shared f32_tile.cuh, int4.cuh,
           wgmma_s8.cuh and mma_bf16.cuh; a line that only the d=256
           instances compile, in the sources named beside it) built (one
           nvcc a core, largest first; with other phases in the run they
           start after build, niced, on all but two cores, behind those
           phases) and bound in place of the committed kernels as each
           build ends, their checks rerun: every fault must fail them (a
           fault of flash_bwd.cu's d=256 kernels or of the d=256 int8-P
           forward a d=256 case by 10x or more, one of the d=256 bf16-P
           forward a d=256 bf16-P case).

Launch counts: every kernel wrapper counts its launches; the counts are
zeroed just before each main path (each solve rung, the harness run,
each int8_modes call, serve, serve's prefill bench, serve_w8a8 and its
prefill bench, each serve_w4 batch, serve_flash, serve_mixed,
serve_hybrid, serve_hybrid_mixed, serve_gemma2_f32's two runs, serve_spec's four runs, train's, train_gemma2's and
train_gemma2_f32's steps, each of
parallel's rings and its
one-rank group, and in every rank of serve_tp's, serve_cp's and
train_parallel's runs: the summary adds rank 0's) runs and read just after,
and a kernel of that path that never launched fails the run. The last
lines are the kernels summary, the card's name and power limit, and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import traceback

REFERENCE_L4_MS = 7.70  # the reference study's fa_tc_int8_b on an NVIDIA L4
SOLVE_REL_RMS_TOL = 0.03  # int8 solve vs the float golden (phase_solve)
PREFILL_BENCH_LEN = 2048  # serving_bench --prefill's prompt (phase_serve)

PHASES = ("build", "kernels", "solve", "harness", "int8_modes", "serve", "serve_w8a8",
          "serve_w4", "serve_flash", "serve_mixed", "serve_hybrid", "serve_hybrid_mixed",
          "serve_gemma2_f32", "serve_spec",
          "serve_hf", "train", "train_gemma2", "train_gemma2_f32", "train_parallel", "parallel",
          "serve_tp", "serve_cp", "faults")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    from quantizedmha_tpu_torch.profiling.device_info import power_limit
    line = power_limit(0)
    if line is None:
        raise RuntimeError("nvidia-smi reported no name and power limit")
    return line


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_median(fn, iters: int, samples: int, warmup: int = 2) -> float:
    """The median of `samples` cuda_ms samples of `iters` calls each, after
    `warmup` calls: one slow sample (a host stall in the launches) does not
    move it."""
    import statistics
    for _ in range(warmup):
        fn()
    return statistics.median(cuda_ms(fn, iters, warmup=0) for _ in range(samples))


def bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the larger of the bytes time and the busiest
    unit's operations time (int8 and bf16 products share the tensor cores;
    fp32 is the CUDA cores' float32; exp the SFUs'), at the card's peaks in
    profiling/roofline.py's CHIP_SPECS (an unknown card raises)."""
    from quantizedmha_tpu_torch.profiling.roofline import detect_chip
    spec = detect_chip()
    t_bytes = nbytes / (spec.hbm_gbps * 1e9)
    t_ops = max(ops.get("int8", 0) / (spec.int8_tops * 1e12)
                + ops.get("bf16", 0) / (spec.bf16_tflops * 1e12),
                ops.get("fp32", 0) / (spec.cuda_core_tflops * 1e12),
                ops.get("exp", 0) / spec.exp_per_s)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def err_over_tol(got, want, tol) -> float:
    """max |got - want| / tol over the elements (tol broadcasts); equal
    values, infinities included, count 0 and a NaN counts inf. The check
    passes at <= 1."""
    import torch
    got, want = got.double(), want.double()
    ratio = torch.where(got == want, torch.zeros_like(got), (got - want).abs() / tol)
    return float(torch.nan_to_num(ratio, nan=float("inf")).max())


def flash_tolerances(o_plain, lse_plain, l, v_i8, v_scales, block_kv, mode):
    """Per-element tolerances of the flash kernel's output and lse (None
    when not saved) against its plain version, from the plain version's
    final P' sum per row (l: [B, H, Sq, 1]).

    The kernel's P' = exp2(fma(...)) sits a few f32 ulps from the plain
    version's exp(s - shift), so a P' within those ulps of a rounding
    boundary can round the other way: an int8 P by one unit, a bf16 P by
    one bf16 ulp (<= 0.5, as P' <= 127). One flip of key j moves the row's
    output by at most max|v| / l, where max|v| is taken over the row's
    (batch, kv head) and l is the row's final P' sum: mode 0 (int8 P), P·V
    moves by |v_j| and l not at all; mode 1 (bf16 P, l over it), P·V and l
    move together, o by at most 0.5 |v_j - o| / l; mode 2 (bf16 P, l over
    the f32 P'), P·V moves by at most 0.5 |v_j| and l not at all. Two flips
    are allowed. 1e-5 max|v| covers the f32 summation order and the ulps of
    P' itself; a bf16 output adds one bf16 ulp of |o|. lse moves by at most
    0.5 / l a flip in mode 1 (l sums the rounded P); in modes 0 and 2 l sums
    the f32 P', so only by f32 rounding."""
    import torch
    from quantizedmha_tpu_torch.ops.quantize import dequantize_kv_blocks
    group = o_plain.shape[1] // v_i8.shape[1]
    vmax = dequantize_kv_blocks(v_i8, v_scales, block_kv).abs().amax(dim=(-2, -1))
    vmax = vmax.repeat_interleave(group, dim=1)[:, :, None, None].double()
    l = l.double()
    inv_l = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    flip = vmax * (2.0 * inv_l + 1e-5)
    tol_o = flip
    if o_plain.dtype == torch.bfloat16:
        tol_o = flip + 2.0**-7 * (o_plain.double().abs() + flip)
    if lse_plain is None:
        return tol_o, None
    tol_lse = ((inv_l[..., 0] if mode == 1 else 0.0) + 1e-5
               + 1e-6 * torch.nan_to_num(lse_plain.double().abs(), posinf=0.0))
    return tol_o, tol_lse


def w4_tolerance(x, w, ref, *, golden=False):
    """Per-element tolerance of a w4a16 product against `ref`: the plain
    version, or with golden=True x.float() @ dequantize_weight4(w) in f32.
    Kernel and plain version both round w = q*s to x's dtype once and sum
    x*w in f32, so they differ by the f32 summation order (1e-5 of
    sum_k |x_k w_k|) and, for a bf16 output, one bf16 ulp (2^-7 |ref|);
    f32's ulp lies inside the first term. The golden keeps w unrounded: a
    bf16 x adds one bf16 rounding of each weight, 2^-8 sum_k |x_k w_k|."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import dequantize_weight4
    bf16 = x.dtype == torch.bfloat16
    sum_abs = x.float().abs() @ dequantize_weight4(w).abs()
    tol = (1e-5 + (2.0**-8 if golden and bf16 else 0.0)) * sum_abs.double()
    if bf16:
        tol = tol + 2.0**-7 * ref.double().abs()
    return tol


def decode_tolerance(o_plain, v_pages, v_scales):
    """Per-element tolerance of the decode kernel against its plain version:
    both compute in f32 and differ only in summation order (1e-5 of the kv
    head's max|v|); a bf16 output adds one bf16 ulp of |o|."""
    import torch
    group = o_plain.shape[1] // v_pages.shape[0]
    vmax = (v_pages.float().abs().amax(dim=(-2, -1)) * v_scales).amax(dim=-1)  # [Hkv]
    tol = 1e-5 * vmax.repeat_interleave(group)[None, :, None].double()
    if o_plain.dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * o_plain.double().abs()
    return tol


def score_err(q_norm, k_norm, D):
    """Bound of the f32 summation-order difference of one score q·k between
    two orders (the kernel's, the plain version's): (D + 16) ulps of the
    Cauchy-Schwarz bound |q|·|k| on the sum of |q_i k_i|."""
    return (D + 16) * 2.0**-24 * q_norm * k_norm


def flash_fwd_tolerances(q, k, v, o_plain, lse_plain, w_abs, *, sm_scale, softcap):
    """Per-element tolerances of the float flash kernel's output and lse
    against its plain version on the same inputs (lse_plain: the plain
    version's lse, which the f32 terms read).

    bf16. Scores: the two sum Q·K in other orders (the kernel's tensor-core
    order, the plain version's matmul), by at most ds per row (score_err
    over the row's scaled |q| and its kv head's largest |k|; softcap's tanh
    adds ulps of the cap). A score moved by ds moves the row's output by at
    most 4 ds max|v|. P·V and l: f32 summation order, 1e-5 of max|v|. The
    kernel rounds P to bf16 against its running max after each 64-key
    tile, the plain version after each block_kv keys. Each rounding is off
    by at most half an ulp, 2^-8 |p|, so the two rounded P of one key
    differ by at most 2^-7 |p|, and the outputs by at most 2^-7 of sum_j
    p_j |v_j| / l, w_abs (the plain version's output on |v|). A bf16 output
    adds one bf16 ulp (2^-7 |o|). lse: ds + 1e-5 (l's order) + f32 rounding
    of m + log l. The kernel takes each p as 2^(x·log2 e − m·log2 e) on the
    SFU: ex2.approx is within ~2^-22 relative, and the argument's rounding
    moves p by at most |m|·2^-24 relative: under the 1e-5 terms of P·V and
    l while |m| < 100, and under the 1e-6·|lse| term of lse beyond (lse is
    within log Skv of m).

    f32 (six bf16 products a product, u = 2^-24). Scores: the plain
    version's f32 sum over D moves a score by at most D·u of sum_i |q_i
    k_i|; the kernel's products leave out a1b2 + a2b1 + a2b2, at most
    1.02·u·|q_i||k_i| each, and its tensor cores round each k16 step of the
    large product by at most 2 ulps of the sum (D/16 steps: D/8·u; the five
    small products' steps are 2^-7 of that): ds = (9D/8 + 2)·u·|q|·max|k|
    (Cauchy-Schwarz). Scores moved by at most ds move each weight p_j / l by
    a factor within exp(±2 ds), so the output by at most expm1(2 ds)·w_abs.
    P·V and l, as a share c of w_abs: the f32 order of acc and l, 2^-20
    (the kernel adds each tile's P·V, summed from zero on the tensor cores,
    to acc on the CUDA cores); ex2.approx against exp, 2^-22; the argument
    m·log2 e rounded, |m|·2^-24·log2 e, with |m| <= |lse| + log Skv; the
    P·V products left out and o's rounding, 2^-23. lse: ds + c + 2^-22 of
    |lse| + log Skv (m + log l rounded, log's ulps). A P or V whose third
    piece is dropped (up to 2^-17 of each p or v) misses c on rows of few
    keys and small scores; a Q or K whose third piece is dropped moves
    large aligned scores by up to 2^-17 of |q||k|, past ds + 2^-22|lse|
    in lse (FLASH_FWD_PIECES). At d=256 the f32 kernel runs true f32 FMAs
    (f32_tile.cuh) and the same terms bound it: its scores differ from
    the plain version's by the f32 order alone, (D + 16)·u of |q||k|
    (score_err), under (9D/8 + 2)·u; expf is within a few ulps of exp,
    under 2^-22; acc and l sum in f32 in another order, the 2^-20 term."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import scaled_q
    D = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    qn = scaled_q(q, sm_scale).double().norm(dim=-1)                        # [B, H, Sq]
    kn = k.double().norm(dim=-1).amax(dim=-1).repeat_interleave(group, dim=1)  # [B, H]
    if q.dtype == torch.float32:
        u = 2.0**-24
        ds = (9 * D / 8 + 2) * u * qn * kn[..., None]
        if softcap is not None:
            ds = ds + 2.0**-22 * softcap
        log_skv = math.log(max(k.shape[2], 1))
        lse_abs = torch.nan_to_num(lse_plain.double().abs(), posinf=0.0)
        c = 2.0**-20 + 2.0**-22 + u * 1.4426950408889634 * (lse_abs + log_skv) + 2.0**-23
        tol_o = (torch.expm1(2.0 * ds) + c)[..., None] * w_abs.double()
        return tol_o, ds + c + 2.0**-22 * (lse_abs + log_skv)
    vmax = v.double().abs().amax(dim=(-2, -1)).repeat_interleave(group, dim=1)
    ds = score_err(qn, kn[..., None], D)
    if softcap is not None:
        ds = ds + 2.0**-22 * softcap
    tol_o = (4.0 * ds + 1e-5)[..., None] * vmax[:, :, None, None]
    tol_o = tol_o + 2.0**-7 * w_abs.double()
    tol_o = tol_o + 2.0**-7 * (o_plain.double().abs() + tol_o)
    tol_lse = ds + 1e-5 + 1e-6 * torch.nan_to_num(lse_plain.double().abs(), posinf=0.0)
    return tol_o, tol_lse


def attention_tolerances(q, kn, vmax, o_plain, lse_plain, *, sm_scale, softcap, w_abs=None):
    """Per-element tolerances of a paged kernel (decode, q [B, Hq, D], or
    prefill, q [B, Hq, C, D]) against its plain version on the same pages.
    Scores: both sum q·k exactly-rounded products in f32 in other orders,
    by at most ds per row (score_err over |q·sm_scale| and kn, the kv head's
    largest dequantized |k|), moving the output by at most 4 ds max|v|; P·V
    and l by 1e-5 of vmax (the kv head's largest dequantized |v|). The bf16
    paged prefill (w_abs given) also rounds each p · v_scale[key] to bf16
    once before P·V, a relative error of at most 2^-8 (round to nearest
    even, 8 significant bits), which moves an output element by at most
    2^-8 of sum_j p_j |v_j| v_scale_j / l: w_abs, the plain walk's output
    on |V| (prefill_w_abs); l sums the unrounded p, so lse keeps its bound.
    A bf16 output adds one ulp. lse: ds + 1e-5 + f32 rounding of m + log l."""
    import torch
    D = q.shape[-1]
    group = q.shape[1] // kn.shape[0]
    shape = (1, -1) + (1,) * (q.dim() - 3)
    qn = (q.double() * sm_scale).norm(dim=-1)                                 # [B, Hq(, C)]
    kn, vmax = (x.double().repeat_interleave(group).reshape(shape) for x in (kn, vmax))
    ds = score_err(qn, kn, D)
    if softcap is not None:
        ds = ds + 2.0**-22 * softcap
    tol_o = ((4.0 * ds + 1e-5) * vmax)[..., None]
    if w_abs is not None:
        tol_o = tol_o + 2.0**-8 * w_abs.double()
    if o_plain.dtype == torch.bfloat16:
        tol_o = tol_o + 2.0**-7 * (o_plain.double().abs() + tol_o)
    tol_lse = ds + 1e-5 + 1e-6 * torch.nan_to_num(lse_plain.double().abs(), posinf=0.0)
    return tol_o, tol_lse


def paged_prefill_tolerances(q, k_pages, v_pages, k_scales, v_scales, o_plain, lse_plain,
                             *, sm_scale, softcap, w_abs=None):
    """attention_tolerances over int8 pages with one scale per (head, page)."""
    kn = (k_pages.double().norm(dim=-1) * k_scales.double()[..., None]).flatten(1).amax(dim=1)
    vmax = (v_pages.double().abs().amax(dim=-1) * v_scales.double()[..., None]).flatten(1).amax(dim=1)
    return attention_tolerances(q, kn, vmax, o_plain, lse_plain, sm_scale=sm_scale,
                                softcap=softcap, w_abs=w_abs)


def int4_tolerances(q, k_pages, v_pages, k_scales, v_scales, o_plain, lse_plain,
                    *, sm_scale, softcap, w_abs=None):
    """attention_tolerances over nibble-packed pages with per-sub-tile
    scales [Hkv, num_pages, subs]."""
    from quantizedmha_tpu_torch.ops.quantize import unpack_int4_halves

    def rows(pages, scales):  # dequantized rows, one kv head at a time: [n, P, D]
        sub = pages.shape[2] // scales.shape[-1]
        for h in range(pages.shape[0]):
            x = torch.cat(unpack_int4_halves(pages[h]), dim=-1).double()
            yield x * scales[h].double().repeat_interleave(sub, dim=-1)[..., None]
    import torch
    kn = torch.stack([r.norm(dim=-1).max() for r in rows(k_pages, k_scales)])
    vmax = torch.stack([r.abs().max() for r in rows(v_pages, v_scales)])
    return attention_tolerances(q, kn, vmax, o_plain, lse_plain, sm_scale=sm_scale,
                                softcap=softcap, w_abs=w_abs)


def prefill_w_abs(q, cache, lengths, q_starts, tables, *, int4=False, sm_scale, window,
                  softcap, sinks, **_):
    """w_abs of the bf16-P term (attention_tolerances): the plain page walk
    (ops/paged_prefill._prefill_walk, q in f32) with |v · v_scale| in place
    of V, taken after unpacking for INT4 pages; None for f32 q, whose kernel
    keeps P in f32."""
    import torch
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.ops.decode import _int4_page
    if q.dtype != torch.bfloat16:
        return None
    k_pages, v_pages, k_scales, v_scales = cache
    heads = torch.arange(k_pages.shape[0], device=q.device)

    def load(page):
        if int4:
            kp, ks = _int4_page(k_pages, k_scales, heads, page)
            vp, vs = _int4_page(v_pages, v_scales, heads, page)
            return kp, ks, lambda p: (p * vs.abs()) @ vp.abs()
        kp = k_pages[:, page].float().transpose(0, 1)                 # [B, Hkv, P, D]
        vp = v_pages[:, page].float().abs().transpose(0, 1)
        ks = k_scales[heads[None, :], page[:, None]][..., None, None]  # [B, Hkv, 1, 1]
        vs = v_scales[heads[None, :], page[:, None]][..., None, None].abs()
        return kp, ks, lambda p: (p @ vp) * vs
    return pp._prefill_walk(q.float(), k_pages.shape[0], lengths, q_starts, tables,
                            k_pages.shape[2], load, sm_scale=sm_scale, window=window,
                            softcap=softcap, sinks=sinks, save_residuals=False)


def merge_tolerance(o, lse_parts, o_parts, tols, lse_tols):
    """Tolerance of a merged output (parallel/combine.merge_two_partials)
    from its two partials' tolerances: o = w_a o_a + w_b o_b with w = exp(
    lse_part - lse), taken from the plain partials. A partial's output
    error moves o by w times it; its lse error moves o by at most w_a w_b
    |o_a - o_b| per unit; the merged bf16 output adds one ulp of |o|."""
    import torch
    (la, lb), (oa, ob) = lse_parts, o_parts
    lse = torch.logaddexp(la.double(), lb.double())
    fin = torch.isfinite(lse)
    wa, wb = (torch.where(fin & torch.isfinite(x), torch.exp(x.double() - lse),
                          torch.zeros_like(lse))[..., None] for x in (la, lb))
    d_lse = (torch.where(torch.isfinite(la), lse_tols[0], 0.0)
             + torch.where(torch.isfinite(lb), lse_tols[1], 0.0))[..., None]
    tol = (wa * tols[0] + wb * tols[1]
           + wa * wb * (oa.double() - ob.double()).abs() * d_lse)
    if o.dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * (o.double().abs() + tol)
    return tol


def _sdpa(q, k, v, **kw):
    """(ms, backend) of one F.scaled_dot_product_attention call on these
    inputs: the first of flash, memory-efficient, cuDNN and math attention
    that takes them. The port never calls it: it is the yardstick."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                sdpa(q, k, v, **kw)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            return cuda_ms(lambda: sdpa(q, k, v, **kw), iters=10), backend.name
    return None, None


# ---------------------------------------------------------------------------


def _ptxas_kernels(log):
    """{kernel<template args>: [registers, spill store bytes]} from one
    `nvcc -Xptxas -v` log."""
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes spill stores", entry)
        mangled = entry.split("'")[1] if "'" in entry else ""
        # _ZN <length><identifier>... (namespaces, then the kernel) I<args>E
        pos, name = 3, ""
        while pos < len(mangled) and mangled[pos].isdigit():
            m = re.match(r"\d+", mangled[pos:])
            pos += len(m.group())
            name = mangled[pos:pos + int(m.group())]
            pos += len(name)
        if name and regs and spills:
            args = ",".join(re.findall(r"L[ib](\d+)E", mangled[pos:].split("EE")[0] + "E"))
            out[f"{name}<{args}>"] = [int(regs.group(1)), int(spills.group(1))]
    return out


def phase_build(st):
    from quantizedmha_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    secs = time.perf_counter() - t0
    regs = {}
    for name, log in logs.items():
        used = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        regs[name] = {"max_registers": max(used, default=None),
                      "max_spill_store_bytes": max(spills, default=None),
                      "kernels": _ptxas_kernels(log),
                      # ptxas C7514: wgmma serialized (a register hazard in the pipeline)
                      "wgmma_serialized": len(re.findall(r"C7514", log))}
    st["gpu"] = gpu_line()
    # The INT8 flash kernels (bf16 P, int8 P) at each head dim and q dtype:
    # [registers, spill store bytes], and the serialized wgmma of their source.
    fa8 = regs.get("flash_int8_fwd", {})
    bf16p, int8p = ({"kernels": {k: x for k, x in fa8.get("kernels", {}).items()
                                 if k.startswith(name)},
                     "wgmma_serialized": fa8.get("wgmma_serialized")}
                    for name in ("flash_int8_bf16p_kernel", "flash_int8_int8p_kernel"))
    emit({"phase": "build", "ok": True, "seconds": round(secs, 2),
          "flash_int8_bf16p": bf16p, "flash_int8_int8p": int8p, "ptxas": regs,
          "gpu": st["gpu"]})


def _flash_case(name, route_mode, q, k, v, block_kv, causal, *, replaces, library, timed=True):
    """Kernel vs plain at one shape, the kernel launched twice (the same
    bits both times, or the case fails); returns the kernels-line entry
    (without times unless `timed`)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    B, H, S, D = q.shape
    k_i8, ks = quantize_kv_blocks(k, block_kv)
    v_i8, vs = quantize_kv_blocks(v, block_kv)
    offsets = fa8._offsets(0, 0, B, q.device)  # q_len == kv_len: end-aligned
    kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=S, block_kv=block_kv,
              scale_clamp=1e-8, p_scale=127.0, window=None, softcap=None,
              sinks=0, mode=route_mode, save_residuals=False)
    # (_operands keeps the tensors behind args' raw pointers alive)
    kernel, args, (out, _), _operands = fa8._flash_int8_launch(
        q, k_i8, ks, v_i8, vs, offsets, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = _same_bits_again(lambda: kernel(*args), [out])
    plain = fa8._flash_int8_plain(q, k_i8, ks, v_i8, vs, offsets, **kw)
    _, _, l = fa8._flash_int8_plain_state(
        q, k_i8, ks, v_i8, vs, offsets,
        **{k: x for k, x in kw.items() if k != "save_residuals"})
    tol, _ = flash_tolerances(plain, None, l, v_i8, vs, block_kv, route_mode)
    ratio = err_over_tol(out, plain, tol)
    entry = {"name": name, "err_over_tol": ratio, "same_bits_twice": same,
             "ok": ratio <= 1.0 and same}
    if not timed:
        return entry
    ms = cuda_ms(lambda: kernel(*args), iters=20)
    plain_ms = cuda_ms(lambda: fa8._flash_int8_plain(q, k_i8, ks, v_i8, vs, offsets, **kw),
                       iters=2, warmup=1)
    lib_ms = None
    if library:
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(lambda: sdpa(qb, kb, vb, is_causal=causal,
                                      enable_gqa=kb.shape[1] != qb.shape[1]), iters=20)
    pairs = S * (S + 1) // 2 if causal else S * S
    Hkv = k.shape[1]
    nbytes = (q.numel() * q.element_size() * 2 + 2 * k_i8.numel()
              + 2 * ks.numel() * 4)
    matmul = 2 * B * H * pairs * D  # one of the two products, flops or ops
    ops = {"int8": matmul * (2 if route_mode == 0 else 1),
           "bf16": 0 if route_mode == 0 else matmul, "exp": B * H * pairs}
    bms, by = bound(nbytes, ops)
    return {**entry, "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/flash_int8_fwd.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - plain.float()).abs().max().item(),
            "tol_range": [tol.min().item(), tol.max().item()],
            "shape": {"B": B, "Hq": H, "Hkv": Hkv, "S": S, "D": D,
                      "causal": causal, "block_kv": block_kv, "q": str(q.dtype)},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def _dense_kv(pages, scales, tables, Hq, dtype=None):
    """The K or V that a paged cache holds for each sequence of `tables`,
    dequantized, as dense [B, Hq, max_pages * P, D] (bf16 unless `dtype`)
    with the kv heads expanded to the q heads (int8 pages with [Hkv, n]
    scales, or nibble-packed pages with [Hkv, n, subs] scales)."""
    import torch
    from quantizedmha_tpu_torch.ops.quantize import unpack_int4_halves
    idx = tables.long()
    x = pages[:, idx]                                                 # [Hkv, B, mp, P, *]
    sc = scales[:, idx]
    if scales.dim() == 3:
        x = torch.cat(unpack_int4_halves(x), dim=-1)
        sc = sc.repeat_interleave(pages.shape[2] // scales.shape[-1], dim=-1)[..., None]
    else:
        sc = sc[..., None, None]
    x = (x.float() * sc).transpose(0, 1)                              # [B, Hkv, mp, P, D]
    B, Hkv = x.shape[:2]
    x = x.reshape(B, Hkv, -1, x.shape[-1]).to(dtype or torch.bfloat16)
    return x.repeat_interleave(Hq // Hkv, dim=1)


def _sdpa_decode(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, window=None,
                 dtype=None):
    """(ms, backend) of SDPA in bf16 (or `dtype`) for one decode step on the
    same K/V dequantized beforehand (untimed), each sequence's length (and,
    given a window, its last `window` keys) as a mask: the yardstick of the
    paged decode kernels."""
    import torch
    Hq, dtype = q.shape[1], dtype or torch.bfloat16
    kd = _dense_kv(k_pages, k_scales, tables, Hq, dtype=dtype)
    vd = _dense_kv(v_pages, v_scales, tables, Hq, dtype=dtype)
    kpos = torch.arange(kd.shape[2], device=q.device)[None, :]
    mask = kpos < lengths[:, None].long()
    if window is not None:
        mask &= kpos >= lengths[:, None].long() - window
    out = _sdpa(q[:, :, None].to(dtype), kd, vd, attn_mask=mask[:, None, None])
    del kd, vd
    return out


# The INT8 decode's main shapes at batch 8: (kv heads, seed, lengths, table
# slots). serve's decode (8 kv heads, 257-300 tokens of context), the same
# kernel for MQA (rows 3 and 4 are one kernel; serve_tp's tp=8 ranks have
# one kv head), and serve_flash's decode at up to 8192 tokens of context (64
# slots).
DECODE_MAIN = {"serve decode": (8, 2, (257, 300), 4), "mqa decode": (1, 3, (257, 300), 4),
               "serve_flash decode": (8, 6, (2048, 8192), 64)}


def _decode_main_inputs(Hkv, *, seed, lengths=(257, 300), max_pages=4):
    """A decode step at batch 8, Llama-3-8B heads, page 128, bf16 q:
    context lengths drawn from the closed range `lengths`, block tables of
    max_pages slots, random int8 pages. Returns the operands of
    ops/decode._paged_decode_launch."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, Hq, D, P = 8, 32, 128, 128
    lengths = torch.randint(lengths[0], lengths[1] + 1, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
    num_pages = B * max_pages + 1
    perm = torch.randperm(num_pages - 1, generator=g, device="cuda")[:B * max_pages] + 1
    tables = perm.reshape(B, max_pages).to(torch.int32)
    k_pages = torch.randint(-127, 128, (Hkv, num_pages, P, D), generator=g,
                            device="cuda", dtype=torch.int8)
    v_pages = torch.randint(-127, 128, (Hkv, num_pages, P, D), generator=g,
                            device="cuda", dtype=torch.int8)
    k_scales = torch.rand((Hkv, num_pages), generator=g, device="cuda") * 0.02 + 0.005
    v_scales = torch.rand((Hkv, num_pages), generator=g, device="cuda") * 0.02 + 0.005
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    return q, k_pages, v_pages, k_scales, v_scales, lengths, tables


def _keeping(kernel, args, keep):
    """kernel(*args) as a function that holds `keep`, the wrapper's
    operands and split scratch, for as long as it lives: a launch timed
    after its check must not write into scratch freed meanwhile."""
    def launch():
        kernel(*args)
    launch.keep = keep
    return launch


def _decode_check(operands, kw):
    """One INT8 decode launch against its plain version, launched twice:
    (output, plain output, err_over_tol (inf when the second launch's
    bits differ), tolerance, launch, same bits)."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    kernel, args, (out, _), _operands = dec._paged_decode_launch(*operands, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = _same_bits_again(lambda: kernel(*args), (out,))
    plain = dec._paged_decode_plain(*operands, **kw)
    tol = decode_tolerance(plain, operands[2], operands[4])
    ratio = err_over_tol(out, plain, tol) if same else float("inf")
    return out, plain, ratio, tol, _keeping(kernel, args, _operands), same


def _decode_case(name, Hkv, *, replaces, seed, lengths=(257, 300), max_pages=4):
    """The decode kernel against its plain version at batch 8, Llama-3-8B
    heads, page 128 (_decode_main_inputs); launched twice, and a second
    launch whose bits differ fails the check."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    operands = _decode_main_inputs(Hkv, seed=seed, lengths=lengths, max_pages=max_pages)
    q, k_pages, v_pages, k_scales, v_scales, lengths, tables = operands
    B, Hq, D = q.shape
    P = k_pages.shape[2]
    kw = dict(sm_scale=D**-0.5, window=None, softcap=None, sinks=0, save_residuals=False)
    out, plain, ratio, tol, launch, same = _decode_check(operands, kw)
    ms = cuda_ms(launch, iters=50)
    # The whole entry point (checks, scratch, ctypes call) on the host
    # clock, 50 calls and one sync: the decode step's host loop pays it
    # twice a layer in serve_mixed.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        dec.paged_decode_attention(*operands)
    torch.cuda.synchronize()
    wrapper_ms = (time.perf_counter() - t0) * 1e3 / 50
    plain_ms = cuda_ms(lambda: dec._paged_decode_plain(*operands, **kw), iters=3, warmup=1)
    lib_ms, backend = _sdpa_decode(q, k_pages, v_pages, k_scales, v_scales, lengths, tables)
    ctx = int(lengths.sum().item())
    nbytes = (q.numel() * 2 * 2 + 2 * ctx * Hkv * D
              + 2 * B * Hkv * max_pages * 4 + B * 4 + tables.numel() * 4)
    bms, by = bound(nbytes, {"fp32": 2 * 2 * ctx * Hq * D, "exp": ctx * Hq})
    splits = dec.decode_splits(B, Hkv, max_pages, P)
    return {"name": name, "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_decode.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - plain.float()).abs().max().item(),
            "err_over_tol": ratio, "tol_range": [tol.min().item(), tol.max().item()],
            "ok": ratio <= 1.0, "same_bits_twice": same,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "page": P,
                      "max_pages": max_pages, "splits": list(splits),
                      "lengths": lengths.tolist()},
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


def _flash_fwd_check(q, k, v, offsets, *, causal, window=None, sinks=0, softcap=None,
                     save_residuals=True):
    """One float flash launch against its plain version on the card:
    (kernel output, plain output, [output, lse] err_over_tol, tolerance,
    launch, plain call). The kernel runs twice: a second launch whose bits
    differ adds an infinite ratio. The f32 route's planes (scratch the
    split pass fills) hold NaN before the first launch, so that a plane
    element the split pass leaves unwritten and the kernel reads shows."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, causal=causal, block_kv=min(1024, k.shape[2]), window=window,
              softcap=softcap, sinks=sinks, save_residuals=save_residuals)
    kernel, args, (out, lse), operands = fa._flash_fwd_launch(q, k, v, offsets, **kw)
    planes = operands[-1]
    if planes is not None:
        planes.fill_(float("nan"))
    kernel(*args)
    torch.cuda.synchronize()
    same = _same_bits_again(lambda: kernel(*args), [x for x in (out, lse) if x is not None])
    p_out, p_lse = fa._flash_fwd_plain(q, k, v, offsets, **dict(kw, save_residuals=True))
    w_abs = fa._flash_fwd_plain(q, k, v.abs(), offsets, **dict(kw, save_residuals=False))
    tol, lse_tol = flash_fwd_tolerances(q, k, v, p_out, p_lse, w_abs, sm_scale=sm,
                                        softcap=softcap)
    ratios = [err_over_tol(out, p_out, tol)]
    if save_residuals:
        ratios.append(err_over_tol(lse, p_lse, lse_tol))
    if not same:
        ratios.append(float("inf"))
    return (out, p_out, ratios, tol, lambda: kernel(*args),
            lambda: fa._flash_fwd_plain(q, k, v, offsets, **kw))


def _visible_pairs(sq, skv, causal):
    """(q, kv) pairs an end-aligned causal (or full) attention computes."""
    if not causal:
        return sq * skv
    return sum(min(skv, skv - sq + i + 1) for i in range(sq) if skv - sq + i + 1 > 0)


def _flash_fwd_case(name, q, k, v, causal, *, replaces, label):
    """The float flash kernel at one main-path shape (end-aligned, no
    window): check (the same bits twice), kernel / plain / SDPA times, the
    bound. SDPA runs on the same inputs: for f32 inputs in f32 (the first
    backend that takes them, memory-efficient attention, with TF32 off), the
    same function as the f32 route, and beside it in bf16 (the library's
    fast path, `library_bf16`). The f32 route's bound counts its six bf16
    passes a product on the tensor cores."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    B, H, S, D = q.shape
    Skv = k.shape[2]
    offsets = _offsets(Skv - S, 0, B, q.device)
    out, p_out, ratios, tol, launch, plain = _flash_fwd_check(q, k, v, offsets, causal=causal,
                                                              save_residuals=False)
    ms = cuda_ms(launch, iters=10)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    lib_ms, backend = _sdpa(qb, kb, vb, is_causal=causal, enable_gqa=kb.shape[1] != qb.shape[1])
    library_bf16 = None
    if q.dtype == torch.float32:
        library_bf16 = {"ms": lib_ms, "backend": backend}
        torch.backends.cuda.matmul.allow_tf32 = False
        lib_ms, backend = _sdpa(q, k, v, is_causal=causal, enable_gqa=k.shape[1] != q.shape[1])
    pairs = B * H * _visible_pairs(S, Skv, causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    passes = 1 if q.dtype == torch.bfloat16 else 6
    bms, by = bound(nbytes, {"bf16": passes * 4 * pairs * D, "exp": pairs})
    return {"name": name, "route": "cuda", "source": "quantizedmha_tpu_torch/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": None, "label": label,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": ratios[0], "tol_range": [tol.min().item(), tol.max().item()],
            "same_bits_twice": len(ratios) == 1,
            "ok": max(ratios) <= 1.0,
            "shape": {"B": B, "Hq": H, "Hkv": k.shape[1], "Sq": S, "Skv": Skv, "D": D,
                      "causal": causal, "dtype": str(q.dtype)},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend,
            **({"library_bf16": library_bf16, "allow_tf32": False} if library_bf16 else {})}


def _paged_cache(g, Hkv, num_pages, P, D):
    """Random int8 pages and per-(head, page) scales on the card."""
    import torch
    k_pages, v_pages = torch.randint(-127, 128, (2, Hkv, num_pages, P, D), generator=g,
                                     device="cuda", dtype=torch.int8)
    k_scales, v_scales = torch.rand((2, Hkv, num_pages), generator=g, device="cuda") * 0.02 + 0.005
    return k_pages, v_pages, k_scales, v_scales


def _same_bits_again(launch, outs):
    """Run launch() once more on the same inputs: whether every output
    tensor it writes comes out with the same bits."""
    import torch
    first = [x.clone() for x in outs]
    launch()
    torch.cuda.synchronize()
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(first, outs))


def _paged_prefill_check(q, cache, lengths, q_starts, tables, *, window=None, sinks=0,
                         softcap=None):
    """One paged prefill launch (with lse) against its plain version:
    (kernel output, plain output, [output, lse] err_over_tol, tolerance,
    launch, plain call). A bf16 launch runs twice: a second launch whose
    bits differ adds an infinite ratio."""
    import torch
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, window=window, softcap=softcap, sinks=sinks, save_residuals=True)
    operands = (q, *cache, lengths, q_starts, tables)
    kernel, args, (out, lse), _operands = pp._paged_prefill_launch(*operands, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = q.dtype != torch.bfloat16 or _same_bits_again(lambda: kernel(*args), (out, lse))
    p_out, p_lse = pp._paged_prefill_plain(*operands, **kw)
    w_abs = prefill_w_abs(q, cache, lengths, q_starts, tables, **kw)
    tol, lse_tol = paged_prefill_tolerances(q, *cache, p_out, p_lse, sm_scale=sm,
                                            softcap=softcap, w_abs=w_abs)
    ratios = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
    if not same:
        ratios.append(float("inf"))
    return (out, p_out, ratios, tol, _keeping(kernel, args, _operands),
            lambda: pp._paged_prefill_plain(*operands, **kw))


# The serve_flash path's heaviest chunk shape: a 2048-row chunk at 4096 of
# context (lengths 6144), Llama-3-8B heads, page 128, bf16 q.
PAGED_MAIN = dict(Hq=32, Hkv=8, D=128, P=128, C=2048, q_start=4096)


def _paged_main_inputs(g):
    """(q, cache, lengths, q_starts, tables) at PAGED_MAIN."""
    import torch
    Hq, Hkv, D, P, C, q0 = (PAGED_MAIN[x] for x in ("Hq", "Hkv", "D", "P", "C", "q_start"))
    n_pages = (q0 + C) // P
    cache = _paged_cache(g, Hkv, n_pages + 1, P, D)
    tables = (torch.randperm(n_pages, generator=g, device="cuda") + 1)[None].to(torch.int32)
    q = torch.randn((1, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor([q0 + C], dtype=torch.int32, device="cuda")
    q_starts = torch.tensor([q0], dtype=torch.int32, device="cuda")
    return q, cache, lengths, q_starts, tables


def _paged_prefill_case(g, *, replaces):
    Hq, Hkv, D, P, C, q0 = (PAGED_MAIN[x] for x in ("Hq", "Hkv", "D", "P", "C", "q_start"))
    ctx = q0 + C
    n_pages = ctx // P
    q, cache, lengths, q_starts, tables = _paged_main_inputs(g)
    out, p_out, ratios, tol, launch, plain = _paged_prefill_check(q, cache, lengths, q_starts,
                                                                  tables)
    ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    # SDPA on the same K/V dequantized to bf16 and expanded to the q heads
    # beforehand (untimed), with the chunk's causal mask made explicit.
    import torch
    k_pages, v_pages, k_scales, v_scales = cache
    idx = tables[0].long()

    def dense(pages, scales):
        x = pages[:, idx].float() * scales[:, idx][..., None, None]      # [Hkv, n, P, D]
        return x.reshape(Hkv, ctx, D).repeat_interleave(Hq // Hkv, dim=0)[None].to(torch.bfloat16)
    kd, vd = dense(k_pages, k_scales), dense(v_pages, v_scales)
    mask = (torch.arange(ctx, device="cuda")[None, :]
            <= q0 + torch.arange(C, device="cuda")[:, None])
    lib_ms, backend = _sdpa(q, kd, vd, attn_mask=mask)
    del kd, vd
    pairs = Hq * (C * q0 + C * (C + 1) // 2)
    nbytes = (2 * q.numel() * 2 + 2 * ctx * Hkv * D + 2 * Hkv * n_pages * 4
              + tables.numel() * 4 + Hq * C * 4)
    bms, by = bound(nbytes, {"bf16": 4 * pairs * D, "exp": pairs})
    return {"name": "paged_prefill", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": max(ratios), "tol_range": [tol.min().item(), tol.max().item()],
            "ok": max(ratios) <= 1.0,
            "shape": dict(PAGED_MAIN, lengths=ctx, save_residuals=True, q="bfloat16"),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


# Small shapes off the main paths, so that every branch of the two kernels
# is held against its plain version: ragged q tiles, quant blocks that are
# not a multiple of the kernel's 64-wide tile, a padded cache (kv tail
# mask), per-sequence offsets, GQA/MQA, window + sinks, softcap, both
# numerics modes at every head dim, both q dtypes and lse.
#   (B, H, Hkv, Sq, Skv, kv_len, D, block_kv, causal, window, sinks,
#    softcap, mode, bf16 q, offsets: None for end-aligned, a q offset per
#    sequence, or a (q offset, kv offset) pair per sequence[, a scale of
#    K's keys 0-31 of every 64-key tile])
# The cases from the tenth on hold MODE_BF16_P's wgmma kernel (128 q rows a
# block; 64-key tiles walked per quant block, twice) at its edges: q rows
# not a multiple of 128, block_kv of 64, 96, 320 and 512 (tiles clipped at
# a block's end, several tiles a sweep), Skv under one tile, a quant block
# wholly masked for some rows of a tile (causal with q offsets; rows of the
# last case's second sequence see no key), window + sinks with skipped
# tiles, softcap on mask-free tiles, d = 32, 64 and 128 (128 not causal),
# f32 and bf16 q, GQA with offsets per sequence. The cases from the
# eighteenth on hold MODE_INT8_P's wgmma kernel (64 q rows a block, one q
# head) at its edges: serve_w4's 512 keys in one quant block of 512, a
# quant block of 1024 over keys padded past kv_len, q rows not a multiple
# of 64, GQA groups of 1, 4 and 8, block_kv of 64, 96, 320 and 40 (Skv
# under one tile), a quant block wholly masked for some rows (offsets per
# sequence), window + sinks with skipped tiles, softcap on mask-free tiles,
# d = 32, 64 and 128, f32 and bf16 q; each draws from its own generator
# (FIRST_INT8P_CASE), so that the cases after FLASH_COVERAGE keep theirs.
# Then d=256 with int8 P, and the bf16-P kernel at d=256 (two consumers
# over the same 64 rows, each a key half of every tile and O's column
# half, Q and K as 128-byte halves, P·V from a bf16 P tile, MODE_BF16_P's l
# from each consumer's ones product) and MODE_BF16_P_F32L (l over the f32
# P') at every head dim.
FLASH_COVERAGE = (
    (2, 4, 2, 100, 192, 192, 32, 64, False, None, 0, None, 1, False, None),
    (2, 4, 2, 100, 192, 192, 64, 96, True, None, 0, None, 0, True, None),
    (1, 4, 1, 130, 256, 200, 128, 128, True, None, 0, None, 0, False, None),
    (1, 4, 2, 96, 192, 192, 128, 64, True, 40, 4, 30.0, 0, True, None),
    (1, 4, 4, 64, 320, 320, 32, 160, True, 50, 0, None, 0, False, None),
    (1, 8, 2, 77, 77, 77, 64, 77, True, None, 0, None, 1, True, None),
    (1, 2, 2, 200, 384, 384, 128, 384, False, None, 0, None, 1, False, None),
    (2, 4, 2, 64, 128, 128, 64, 64, True, None, 0, None, 0, False, (10, 50)),
    (1, 4, 2, 80, 160, 160, 32, 32, True, 24, 2, 20.0, 1, False, None),
    (1, 2, 2, 150, 256, 256, 32, 64, True, None, 0, None, 1, False, None),
    (1, 2, 1, 200, 384, 384, 64, 96, False, None, 0, None, 1, True, None),
    (2, 4, 2, 130, 640, 600, 32, 320, True, None, 0, None, 1, False, (0, 200)),
    (1, 4, 4, 64, 48, 48, 128, 48, False, None, 0, None, 1, True, None),
    (1, 2, 1, 300, 512, 512, 64, 256, True, 64, 4, None, 1, False, None),
    (1, 4, 2, 96, 256, 256, 64, 128, False, None, 0, 25.0, 1, True, None),
    (1, 2, 2, 70, 512, 512, 128, 512, False, None, 0, None, 1, False, None),
    (2, 8, 2, 96, 192, 192, 32, 64, True, None, 0, None, 1, True, ((70, 10), (0, 40))),
    (1, 8, 2, 512, 512, 512, 128, 512, True, None, 0, None, 0, True, None),
    (1, 4, 1, 300, 1024, 600, 128, 1024, True, None, 0, None, 0, False, None),
    (1, 2, 2, 100, 320, 320, 64, 320, True, None, 0, None, 0, True, None),
    (1, 8, 1, 70, 40, 40, 32, 40, False, None, 0, None, 0, False, None),
    (2, 4, 2, 96, 192, 192, 64, 96, True, None, 0, None, 0, True, ((70, 10), (0, 40))),
    (1, 4, 2, 400, 512, 400, 128, 128, True, 64, 4, None, 0, True, None),
    (1, 4, 2, 128, 256, 256, 64, 256, False, None, 0, 25.0, 0, False, None),
    (2, 2, 2, 150, 256, 256, 32, 64, True, None, 0, None, 0, True, (10, 50)),
    # d=256 (Gemma-2's head dim, int8 P only): odd lengths with kv_len < Skv
    # and softcap, window + sinks in f32, offsets per sequence, GQA 8 not
    # causal, and two quant blocks the second sequence's offset masks.
    (1, 4, 2, 77, 200, 190, 256, 200, True, None, 0, 50.0, 0, True, None),
    (1, 4, 2, 300, 512, 512, 256, 256, True, 64, 4, None, 0, False, None),
    (2, 4, 2, 96, 192, 192, 256, 64, True, None, 0, 50.0, 0, True, ((70, 10), (0, 40))),
    (1, 8, 1, 70, 128, 128, 256, 128, False, None, 0, None, 0, True, None),
    (2, 2, 1, 130, 256, 256, 256, 128, True, None, 0, None, 0, False, (0, 100)),
    # d=256 with bf16 P, modes 1 and 2 in turn: odd lengths with kv_len <
    # Skv and softcap, window + sinks, offsets per sequence, GQA 8 not
    # causal, f32 and bf16 q in both modes; mode 2 over two quant blocks the
    # second sequence's offset masks. Then mode 2 at d = 32, 64 and 128.
    (1, 4, 2, 77, 200, 190, 256, 200, True, None, 0, 50.0, 1, True, None),
    (1, 4, 2, 77, 200, 190, 256, 200, True, None, 0, 50.0, 2, False, None),
    (1, 4, 2, 300, 512, 512, 256, 256, True, 64, 4, None, 1, False, None),
    (1, 4, 2, 300, 512, 512, 256, 256, True, 64, 4, None, 2, True, None),
    (2, 4, 2, 96, 192, 192, 256, 64, True, None, 0, 50.0, 1, False, ((70, 10), (0, 40))),
    (2, 4, 2, 96, 192, 192, 256, 64, True, None, 0, 50.0, 2, True, ((70, 10), (0, 40))),
    (1, 8, 1, 70, 128, 128, 256, 128, False, None, 0, None, 1, True, None),
    (1, 8, 1, 70, 128, 128, 256, 128, False, None, 0, None, 2, False, None),
    (2, 2, 1, 130, 256, 256, 256, 128, True, None, 0, None, 2, False, (0, 100)),
    (1, 2, 2, 150, 256, 256, 32, 64, True, None, 0, 20.0, 2, False, None),
    (2, 4, 2, 96, 192, 192, 64, 96, True, 40, 4, None, 2, True, ((70, 10), (0, 40))),
    (1, 4, 4, 200, 384, 384, 128, 384, False, None, 0, None, 2, False, None),
    # d=256 with int8 P, cases that tell the two consumers' key halves
    # apart (a 16th element scales K's keys 0-31 of every 64-key tile
    # before quantization): every row's block max in keys 32-63 of its
    # tiles (K's first halves at a quarter) over three quant blocks with
    # softcap; a 40-key window, whose rows see one half of a tile and not
    # the other; kv_len ending inside a tile's first half (keys 192-199 of
    # the last quant block, keys 224-255 all past it).
    (1, 4, 2, 160, 384, 384, 256, 128, True, None, 0, 50.0, 0, True, None, 0.25),
    (1, 4, 4, 128, 320, 320, 256, 320, True, 40, 0, None, 0, False, None),
    (2, 2, 1, 100, 256, 200, 256, 128, True, None, 0, None, 0, True, None),
    # The same edges with bf16 P, whose d=256 kernel splits each tile's
    # keys between two consumers as well: the rows' maxes in keys 32-63 in
    # both modes (mode 2 with f32 q), the 40-key window in mode 2, kv_len
    # inside a tile's first half in mode 1.
    (1, 4, 2, 160, 384, 384, 256, 128, True, None, 0, 50.0, 1, True, None, 0.25),
    (1, 4, 2, 160, 384, 384, 256, 128, True, None, 0, 50.0, 2, False, None, 0.25),
    (1, 4, 4, 128, 320, 320, 256, 320, True, 40, 0, None, 2, False, None),
    (2, 2, 1, 100, 256, 200, 256, 128, True, None, 0, None, 1, True, None),
)
FIRST_INT8P_CASE = 17
# The bf16-P modes told apart: (B, H, Hkv, S, D, block_kv, causal, mode),
# f32 q (a bf16 output's rounding would hide the difference). Every row
# sees key 0 at the row max and every other key at one score whose P'
# (about 100.2) rounds down to bf16 by 0.2 (one_sided_inputs), and V is one
# value: mode 1's l sums the rounded P', so o = v, while mode 2's sums the
# f32 P' and o sits about 2^-9 |v| below, far outside flash_tolerances'
# 2 max|v| / l once a row sees hundreds of keys. Each case is held to its
# own mode's plain version; a kernel with the other mode's l fails it.
FLASH_ONE_SIDED = ((1, 4, 2, 1024, 32, 512, False, 1), (1, 4, 2, 1024, 32, 512, False, 2),
                   (1, 2, 1, 768, 256, 256, True, 1), (1, 2, 1, 768, 256, 256, True, 2))
ONE_SIDED_P = 100.2  # P' of every key below the row max: bf16 spacing 0.5 there


def one_sided_inputs(case, device="cuda"):
    """(q, k_i8, k_scales, v_i8, v_scales, offsets, kw) of a
    FLASH_ONE_SIDED case (kw: the plain version's keywords with lse). q
    is 127 in column 0 and 0 elsewhere (Q quantizes to itself, scale 1);
    K is 127 in column 1 of every key (a block scale of 1), 127 in column 0
    of key 0 and 126 in every other key's, integers elsewhere; so S = 127 ·
    127 at key 0 and 127 · 126 at the others, and sm_scale puts the others'
    P' = 127 exp(-127 sm_scale) at ONE_SIDED_P. V is 0.75 everywhere."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    B, H, Hkv, S, D, bkv, causal, mode = case
    g = torch.Generator().manual_seed(S + D + mode)
    q = torch.zeros((B, H, S, D))
    q[..., 0] = 127.0
    k = torch.randint(-127, 128, (B, Hkv, S, D), generator=g).float()
    k[..., 0] = 126.0
    k[..., 0, 0] = 127.0
    k[..., 1] = 127.0
    v = torch.full((B, Hkv, S, D), 0.75)
    sm = float(torch.tensor(math.log(127.0 / ONE_SIDED_P) / 127.0, dtype=torch.float32))
    k_i8, ks = quantize_kv_blocks(k, bkv)
    v_i8, vs = quantize_kv_blocks(v, bkv)
    assert torch.equal(k_i8.float(), k) and bool((ks == 1.0).all())
    kw = dict(sm_scale=sm, causal=causal, kv_len=S, block_kv=bkv, scale_clamp=1e-8,
              p_scale=127.0, window=None, softcap=None, sinks=0, mode=mode,
              save_residuals=True)
    return tuple(x.to(device) for x in (q, k_i8, ks, v_i8, vs)) + (
        fa8._offsets(0, 0, B, device), kw)
#   (B, Hq, Hkv, D, page, window, sinks, softcap, bf16 q, table slots,
#    lengths (None: drawn from 1 to a full table), scores far below zero)
# The first three hold tables of 6 slots (one split); the rest hold 20-40
# slots, several splits (ops/decode.decode_splits): window + sinks with
# whole splits behind the window, lengths of 1 and below one split, MQA
# at 20 pages (32 and 64 query heads, the latter two blocks), and scores
# below -200 (q against all-positive keys), where a merge that took an
# empty split's m as 0 would underflow every weight.
DECODE_COVERAGE = (
    (3, 8, 2, 32, 16, None, 0, None, False, 6, None, False),
    (3, 4, 4, 64, 32, 20, 3, 50.0, True, 6, None, False),
    (2, 8, 1, 128, 16, 7, 0, None, False, 6, None, False),
    (3, 8, 2, 64, 16, 100, 5, None, True, 40, (640, 500, 300), False),
    (2, 8, 2, 128, 32, 200, 3, 30.0, False, 24, (768, 700), False),
    (4, 8, 2, 32, 16, None, 0, None, False, 32, (1, 5, 40, 512), False),
    (4, 8, 2, 64, 16, None, 0, None, True, 32, (1, 63, 64, 300), False),
    (2, 32, 1, 128, 128, None, 0, None, True, 20, (2560, 1800), False),
    (2, 64, 1, 64, 64, None, 0, None, False, 20, (1280, 900), False),
    (3, 8, 2, 64, 16, None, 0, None, False, 24, (384, 100, 30), True),
)


#   (B, H, Hkv, Sq, Skv, D, causal, window, sinks, softcap, bf16, (q_off, kv_off) or None;
#    an offset may be a tuple, one per sequence)
# The bf16 cases from the eighth on hold the wgmma kernel's block rows (all
# q heads of a kv head's group times rows / group positions; 128 rows at
# d=32, 192 above) at its edges: Sq a multiple of neither the rows nor
# rows / group, Skv under one 64-key tile, groups of 1, 3, 5 and 8, groups
# that leave rows of a block empty (3 at d=32, 5 at d=128), groups of more
# than a block's rows (130 at d=32, 200 at d=64: two head chunks),
# sequences with their own offsets (rows of the second see no key), a
# window with sink tiles and skipped tiles between, softcap on tiles with
# no masked pair, d = 32, 64 and 128. The cases from FIRST_F32_CASE on hold
# the f32 route's six-pass kernel (192 rows at d=32, 128 at d=64, 64 rows
# and 32-key tiles at d=128) at its edges, each drawing from its own
# generator: d=64 causal GQA 4 with a ragged q tile over five key tiles, a
# fold of 130 q heads over one kv head at Sq=5 over a ragged key tile,
# d=128 with offsets per sequence and softcap over seven 32-key tiles, a
# window with sinks at d=32 over seven 64-key tiles, d=128 GQA 2 not
# causal over three tiles.
FLASH_FWD_COVERAGE = (
    (2, 4, 2, 100, 190, 32, False, None, 0, None, False, None),
    (2, 4, 2, 100, 190, 64, True, None, 0, None, True, None),
    (1, 4, 1, 130, 130, 128, True, 40, 4, None, True, None),
    (1, 4, 1, 130, 130, 128, True, 40, 4, None, False, None),
    (1, 8, 2, 77, 77, 64, True, None, 0, 20.0, True, None),
    (1, 2, 2, 96, 160, 32, True, None, 0, 30.0, False, (10, 50)),
    (2, 4, 4, 64, 64, 128, False, None, 0, None, False, None),
    (1, 8, 2, 75, 75, 128, True, None, 0, None, True, None),
    (2, 4, 2, 20, 40, 32, False, None, 0, None, True, None),
    (1, 2, 2, 200, 200, 128, True, None, 0, None, True, None),
    (1, 6, 2, 90, 150, 32, True, None, 0, None, True, None),
    (1, 16, 2, 50, 120, 32, True, None, 0, None, True, None),
    (1, 130, 1, 5, 70, 32, True, None, 0, None, True, None),
    (2, 8, 2, 96, 160, 64, True, None, 0, None, True, ((70, 10), (0, 40))),
    (1, 8, 2, 400, 400, 128, True, 64, 4, None, True, None),
    (1, 4, 2, 128, 256, 64, False, None, 0, 30.0, True, None),
    (1, 10, 2, 60, 90, 128, True, None, 0, None, True, None),
    (1, 200, 1, 3, 40, 64, True, None, 0, None, True, None),
    (1, 8, 2, 100, 260, 64, True, None, 0, None, False, None),
    (1, 130, 1, 5, 70, 32, True, None, 0, None, False, None),
    (2, 4, 2, 150, 200, 128, True, None, 0, 20.0, False, ((60, 10), (0, 50))),
    (1, 4, 1, 200, 400, 32, True, 64, 4, None, False, None),
    (1, 6, 3, 70, 96, 128, False, None, 0, None, False, None),
)
FIRST_F32_CASE = 18
# f32 cases built so that a dropped third bf16 piece shows, each
#   (B, H, Hkv, S, kind); causal, end-aligned, d=32:
# "pv": scores in [-0.02, 0] with key 0 at 0 (every row's max, p = 1 and
#   v = 0), V positive with its third piece near its largest (2^-17 of v):
#   rows of few keys lose up to 2^-17 of w_abs with P's third piece, all
#   rows 2^-17 with V's.
# "qk": Q (scaled) and K constant, each with its third piece near its
#   largest: every score ~1030, the sum of 32 aligned products, which Q's
#   or K's third piece moves by 2^-17 in every row's lse.
FLASH_FWD_PIECES = ((4, 32, 4, 80, "pv"), (1, 4, 1, 70, "qk"))
# 1 + 1.5·2^-9 + (2^-17 - 2^-23): bf16 pieces 1, 1.5·2^-9, 2^-17 - 2^-23.
PIECES_VALUE = 1 + 1.5 * 2**-9 + 2**-17 - 2**-23


def _f32_preimage(target, scale):
    """An f32 x with x·scale rounded to f32 equal to the f32 target."""
    import torch
    t, s = (torch.tensor(x, dtype=torch.float32) for x in (target, scale))
    x = (t.double() / s.double()).float()
    for _ in range(8):
        y = x * s
        if y == t:
            return float(x)
        x = torch.nextafter(x, torch.tensor(math.inf if y < t else -math.inf))
    raise AssertionError(f"no f32 preimage of {target} under {scale}")


def flash_fwd_pieces_inputs(g, case, device="cuda"):
    """(q, k, v) of a FLASH_FWD_PIECES case, f32, from the generator g."""
    import torch
    B, H, Hkv, S, kind = case
    D = 32
    if kind == "pv":
        q = torch.rand((B, H, S, D), generator=g, device=device) * 0.02
        k = -torch.rand((B, Hkv, S, D), generator=g, device=device)
        e = torch.randint(-1, 2, (B, Hkv, S, D), generator=g, device=device)
        v = torch.ldexp(torch.full((B, Hkv, S, D), PIECES_VALUE, device=device), e.float())
        k[:, :, 0] = 0.0
        v[:, :, 0] = 0.0
        return q, k, v
    qv = _f32_preimage(4 * PIECES_VALUE, D**-0.5)
    q = torch.full((B, H, S, D), qv, device=device)
    k = torch.full((B, Hkv, S, D), 8 * PIECES_VALUE, device=device)
    v = torch.randn((B, Hkv, S, D), generator=g, device=device)
    return q, k, v


#   (Hq, Hkv, D, page, C, lengths, q_starts, window, sinks, softcap, bf16 q)
# The bf16 cases (tensor cores) also cover d=32, pages of 16 and 32 keys
# (shorter than the kernel's 64-key tile), a window with sink tiles and
# skipped tiles between, GQA groups of 3, 8 and 64 (one q position a tile).
PAGED_PREFILL_COVERAGE = (
    (8, 2, 32, 16, 40, (40, 90), (0, 50), None, 0, None, False),
    (4, 4, 64, 32, 33, (100,), (67,), 30, 3, None, True),
    (8, 1, 128, 128, 70, (200, 70, 0), (130, 0, 0), None, 0, 10.0, True),
    (6, 2, 64, 64, 20, (300,), (280,), 64, 0, None, False),
    (32, 8, 128, 128, 130, (900,), (770,), None, 0, None, True),
    (8, 2, 32, 16, 40, (40, 90), (0, 50), None, 0, None, True),
    (4, 2, 64, 32, 100, (300, 100), (200, 0), None, 0, None, True),
    (8, 2, 128, 64, 150, (500,), (350,), 100, 5, None, True),
    (8, 1, 64, 16, 70, (200, 70), (130, 0), None, 0, 20.0, True),
    (6, 2, 64, 16, 50, (120,), (70,), None, 0, None, True),
    (64, 1, 32, 16, 5, (37,), (32,), None, 0, None, True),
)


def _coverage_float(g):
    """FLASH_FWD_COVERAGE and PAGED_PREFILL_COVERAGE: kernel against plain
    on the card, [output, lse] err_over_tol per case."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    ratios, failed = {}, []
    for i, case in enumerate(FLASH_FWD_COVERAGE):
        gi = g if i < FIRST_F32_CASE else torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v, offsets, masks = flash_fwd_coverage_inputs(gi, case)
        _, _, r, *_ = _flash_fwd_check(q, k, v, offsets, **masks)
        ratios[f"flash_fwd{i}"] = r
        if max(r) > 1.0:
            failed.append(f"flash_fwd{i}")
    for i, case in enumerate(FLASH_FWD_PIECES):
        gi = torch.Generator(device="cuda").manual_seed(200 + i)
        q, k, v = flash_fwd_pieces_inputs(gi, case)
        _, _, r, *_ = _flash_fwd_check(q, k, v, _offsets(0, 0, case[0], q.device), causal=True)
        ratios[f"flash_fwd_pieces{i}"] = r
        if max(r) > 1.0:
            failed.append(f"flash_fwd_pieces{i}")
    for i, case in enumerate(PAGED_PREFILL_COVERAGE):
        *inputs, masks = paged_prefill_coverage_inputs(g, case)
        _, _, r, *_ = _paged_prefill_check(*inputs, **masks)
        ratios[f"paged_prefill{i}"] = r
        if max(r) > 1.0:
            failed.append(f"paged_prefill{i}")
    return ratios, failed


def flash_fwd_coverage_inputs(g, case, device="cuda"):
    """(q, k, v, offsets, masks) of a FLASH_FWD_COVERAGE case, drawn from
    the generator g; masks holds causal, window, sinks and softcap."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    B, H, Hkv, Sq, Skv, D, causal, window, sinks, cap, bf16, offs = case
    dt = torch.bfloat16 if bf16 else torch.float32
    q = (torch.randn((B, H, Sq, D), generator=g, device=device) * 1.5).to(dt)
    k, v = torch.randn((2, B, Hkv, Skv, D), generator=g, device=device).to(dt)
    q_off, kv_off = offs if offs is not None else (Skv - Sq, 0)
    return (q, k, v, _offsets(q_off, kv_off, B, q.device),
            dict(causal=causal, window=window, sinks=sinks, softcap=cap))


def flash_coverage_inputs(g, case, device="cuda"):
    """(q, k_i8, k_scales, v_i8, v_scales, offsets, kw) of a FLASH_COVERAGE
    case, drawn from the generator g; kw holds the plain version's keywords
    (save_residuals=True)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    (B, H, Hkv, Sq, Skv, kv_len, D, bkv, causal, window, sinks, cap, mode, qbf16,
     offs, *k_lo) = case
    dt = torch.bfloat16 if qbf16 else torch.float32
    q = (torch.randn((B, H, Sq, D), generator=g, device=device) * 2).to(dt)
    kv = torch.randn((2, B, Hkv, Skv, D), generator=g, device=device).to(dt)
    if k_lo:  # K's keys 0-31 of every 64-key tile scaled
        lo = (torch.arange(Skv, device=device) % 64 < 32)[:, None]
        kv[0] = torch.where(lo, kv[0] * k_lo[0], kv[0])
    k_i8, ks = quantize_kv_blocks(kv[0], bkv)
    v_i8, vs = quantize_kv_blocks(kv[1], bkv)
    if offs is None:
        qo, kvo = kv_len - Sq, 0
    elif isinstance(offs[0], tuple):
        qo, kvo = (torch.tensor(x, device=device) for x in zip(*offs))
    else:
        qo, kvo = torch.tensor(offs, device=device), 0
    kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=kv_len, block_kv=bkv,
              scale_clamp=1e-8, p_scale=127.0, window=window, softcap=cap,
              sinks=sinks, mode=mode, save_residuals=True)
    return q, k_i8, ks, v_i8, vs, fa8._offsets(qo, kvo, B, q.device), kw


def _flash_coverage_ratios(g):
    """FLASH_COVERAGE and FLASH_ONE_SIDED: the INT8 flash kernel against
    plain on the card, each case launched twice, {case: [output, lse]
    err_over_tol} (a third entry, inf, when the second launch's bits
    differ)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    ratios = {}
    cases = [(f"fa8_{i}", c) for i, c in enumerate(FLASH_COVERAGE)]
    cases += [(f"fa8_onesided{i}", c) for i, c in enumerate(FLASH_ONE_SIDED)]
    for i, (name, case) in enumerate(cases):
        if name.startswith("fa8_onesided"):
            *operands, kw = one_sided_inputs(case)
        else:
            gi = g if i < FIRST_INT8P_CASE else torch.Generator(device="cuda").manual_seed(i)
            *operands, kw = flash_coverage_inputs(gi, case)
        kernel, args, (out, lse), _operands = fa8._flash_int8_launch(*operands, **kw)
        kernel(*args)
        torch.cuda.synchronize()
        same = _same_bits_again(lambda: kernel(*args), (out, lse))
        p_out, p_lse = fa8._flash_int8_plain(*operands, **kw)
        _, _, l = fa8._flash_int8_plain_state(
            *operands, **{k: x for k, x in kw.items() if k != "save_residuals"})
        tol, lse_tol = flash_tolerances(p_out, p_lse, l, operands[3], operands[4],
                                        kw["block_kv"], kw["mode"])
        ratios[name] = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
        if not same:
            ratios[name].append(float("inf"))
    return ratios


# --- head_dim 256 (Gemma-2): rows 3, 5 (bf16), 10 (bf16 q), 11 and 12 --------

# Gemma-2-9B's attention (LlamaConfig.gemma2_9b): 16 q heads over 8 kv
# heads of 256, sm_scale 256^-0.5 (query_pre_attn_scalar), softcap 50, a
# 4096-key window on even layers, page 128.
GEMMA2_ATTN = dict(Hq=16, Hkv=8, D=256, P=128, softcap=50.0, window=4096)
#   (B, Hq, Hkv, page, window, softcap, table slots, lengths, bf16 q, int4,
#    scrap)
# A Gemma-2 sliding layer at serve_hybrid's depth (several splits, the
# slots behind the window on the scrap page), its full layer, GQA 2 on
# 16-key pages, GQA 8 with f32 q and a length of 1, and INT4 pages (row 12)
# of 4 sub-tiles with an empty sequence.
D256_DECODE = (
    (3, 16, 8, 128, 4096, 50.0, 64, (6064, 4200, 300), True, False, True),
    (3, 16, 8, 128, None, 50.0, 64, (6064, 1864, 364), True, False, False),
    (2, 4, 2, 16, 40, None, 24, (300, 41), True, False, True),
    (2, 8, 1, 32, None, 30.0, 20, (600, 1), False, False, False),
    (3, 16, 8, 128, 4096, 50.0, 48, (6000, 4200, 0), True, True, True),
)
#   (Hq, Hkv, page, C, lengths, q_starts, window, sinks, softcap, int4, scrap,
#    bf16 q)
# bf16 q: a Gemma-2 sliding layer's chunk past the window (scrap slots),
# its full layer over two sequences, GQA 4 on 32-key pages with sinks
# (scrap slots between the sinks and the window), INT4 pages (row 11) of 4
# sub-tiles past the window, and INT4 with a negative q_start. f32 q (the
# CUDA-core route, V's tile in K's): the sliding chunk, the 32-key pages
# with sinks, INT4 with a negative q_start (16-key sub-tiles) and INT4 over
# the full layer's two sequences.
D256_PREFILL = (
    (16, 8, 128, 300, (6000,), (5700,), 4096, 0, 50.0, False, True, True),
    (16, 8, 128, 200, (2000, 150), (1800, 0), None, 0, 50.0, False, False, True),
    (8, 2, 32, 130, (500, 300), (370, 170), 100, 3, None, False, True, True),
    (16, 8, 128, 300, (6000,), (5700,), 4096, 0, 50.0, True, True, True),
    (4, 2, 64, 100, (200, 30), (100, -40), None, 0, 20.0, True, False, True),
    (16, 8, 128, 300, (6000,), (5700,), 4096, 0, 50.0, False, True, False),
    (8, 2, 32, 130, (500, 300), (370, 170), 100, 3, None, False, True, False),
    (4, 2, 64, 100, (200, 30), (100, -40), None, 0, 20.0, True, False, False),
    (16, 8, 128, 200, (2000, 150), (1800, 0), None, 0, 50.0, True, False, False),
)
#   FLASH_FWD_COVERAGE's tuples at d=256, bf16 then f32 (the CUDA-core
# route): Gemma-2's GQA 2 with softcap, a window that skips tiles (4096
# scaled to the case), a ragged non-causal case, offsets per sequence,
# window + sinks.
D256_FLASH = (
    (1, 16, 8, 600, 600, 256, True, None, 0, 50.0, True, None),
    (1, 4, 2, 700, 700, 256, True, 256, 0, 50.0, True, None),
    (2, 4, 2, 100, 190, 256, False, None, 0, None, True, None),
    (2, 4, 2, 96, 160, 256, True, None, 0, None, True, ((70, 10), (0, 40))),
    (1, 8, 4, 400, 400, 256, True, 64, 4, 30.0, True, None),
    (1, 16, 8, 600, 600, 256, True, None, 0, 50.0, False, None),
    (1, 4, 2, 700, 700, 256, True, 256, 0, 50.0, False, None),
    (2, 4, 2, 100, 190, 256, False, None, 0, None, False, None),
    (2, 4, 2, 96, 160, 256, True, None, 0, None, False, ((70, 10), (0, 40))),
    (1, 8, 4, 400, 400, 256, True, 64, 4, 30.0, False, None),
)
D256_SUBS = 4  # scale sub-tiles a page of the INT4 cases
#   (Hq, Hkv, D, C, lengths, window, softcap, scrap, int4): row 10 (row 11
# where int4) at verify_step's shape, bf16 q on pages of 128: B = 4 or 8
# sequences of C = k + 1 rows, each at its own offset (q_start = length -
# C; a padded lane's length is C + 1), Gemma-2's heads at d=256 (a sliding
# layer with the slots behind its window on the scrap page, a full layer)
# and Llama-3-8B's at d=128. Every case takes the split key walk
# (ops/paged_prefill.prefill_splits: S > 1). The INT4 cases are a mixed
# cache's INT4 partial in its own frame: a sequence of length 0 (all its
# rows at negative positions, every split empty) and one that straddles
# the boundary (rows that see nothing beside rows that see keys).
VERIFY_COVERAGE = (
    (16, 8, 256, 5, (353, 1853, 5053, 4253), 4096, 50.0, True, False),
    (16, 8, 256, 5, (353, 1853, 5053, 4253), None, 50.0, False, False),
    (16, 8, 256, 9, (309, 1809, 5009, 4209, 130, 10, 10, 10), 4096, 50.0, True, False),
    (16, 8, 256, 2, (302, 1802, 5002, 4202), 4096, 50.0, True, False),
    (32, 8, 128, 2, (1000, 258, 4500, 3), 4096, 50.0, True, False),
    (32, 8, 128, 5, (129, 5000, 700, 6, 6, 6, 6, 6), 4096, 50.0, True, False),
    (32, 8, 128, 9, (4105, 4300, 140, 9000), 4096, 50.0, True, False),
    (16, 8, 256, 5, (353, 3, 5053, 0), None, 50.0, False, True),
    (32, 8, 128, 5, (129, 5000, 700, 3, 0, 6, 6, 6), None, None, False, True),
)
# serve_tp's speculation at its rank's heads (Llama-3-8B at tp = 4: 8 q / 2
# kv heads, d=128): 4 sequences of k + 1 = 5 rows at 256-token prompts and
# up to 32 new tokens, tables of 3 slots (its engine's max_pages_per_seq).
VERIFY_TP = dict(case=(8, 2, 128, 5, (261, 270, 279, 288), None, None, False, False), slots=3)


def _scrap_behind(cache, tables, first_visible, sinks, P):
    """Point every table slot wholly behind the window (no key at or past
    first_visible[b], and no sink key) at scrap page 0, filled with 0x7f
    bytes and scale 1e30 as a trimmed page may hold anything: a kernel
    that reads such a page shows it. Returns (cache, the cache with the
    scrap page zeroed, for the tolerances, tables)."""
    import torch
    k_pages, v_pages, k_scales, v_scales = (x.clone() for x in cache)
    clean = [x.clone() for x in (k_pages, v_pages, k_scales, v_scales)]
    for x in (k_pages, v_pages):
        x[:, 0] = 0x7f
    for x in (k_scales, v_scales):
        x[:, 0] = 1e30
    for x in clean:
        x[:, 0] = 0
    tables = tables.clone()
    slot_end = (torch.arange(tables.shape[1], device=tables.device) + 1) * P
    behind = ((slot_end[None, :] <= first_visible.long()[:, None])
              & (slot_end[None, :] - P >= sinks))
    tables[behind] = 0
    return (k_pages, v_pages, k_scales, v_scales), tuple(clean), tables


def _d256_check(q, cache, lengths, tables, q_starts=None, *, int4, clean, window, sinks,
                softcap):
    """One paged launch at d=256 with lse, decode (q [B, Hq, D]) or prefill
    (q [B, Hq, C, D], q_starts), INT8 or INT4 pages, against its plain
    version; the tolerances read `clean` (the cache without its scrap
    page). Launched twice: (kernel output, plain output, [output, lse]
    err_over_tol (a third, inf, when the bits differ), launch, plain)."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, window=window, softcap=softcap, sinks=sinks, save_residuals=True)
    if q_starts is None:
        operands = (q, *cache, lengths, tables)
        launch_fn = dec._paged_decode_launch
        plain_fn = dec._paged_decode_int4_plain if int4 else dec._paged_decode_plain
        w_abs = None
    else:
        operands = (q, *cache, lengths, q_starts, tables)
        launch_fn = pp._paged_prefill_launch
        plain_fn = pp._paged_prefill_int4_plain if int4 else pp._paged_prefill_plain
        w_abs = prefill_w_abs(q, clean, lengths, q_starts, tables, int4=int4, **kw)
    kernel, args, (out, lse), _operands = launch_fn(*operands, int4=int4, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = _same_bits_again(lambda: kernel(*args), (out, lse))
    p_out, p_lse = plain_fn(*operands, **kw)
    tols = (int4_tolerances if int4 else paged_prefill_tolerances)(
        q, *clean, p_out, p_lse, sm_scale=sm, softcap=softcap, w_abs=w_abs)
    ratios = [err_over_tol(out, p_out, tols[0]), err_over_tol(lse, p_lse, tols[1])]
    if not same:
        ratios.append(float("inf"))
    return out, p_out, ratios, _keeping(kernel, args, _operands), lambda: plain_fn(*operands, **kw)


def _d256_decode_inputs(g, case):
    """(q, cache, lengths, tables, clean, masks) of a D256_DECODE case."""
    import torch
    B, Hq, Hkv, P, window, cap, slots, lens, bf16, int4, scrap = case
    n = B * slots + 1
    cache = (_int4_cache(g, Hkv, n, P, 256, D256_SUBS) if int4
             else _paged_cache(g, Hkv, n, P, 256))
    tables = _tables_for(g, B, slots, n)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Hq, 256), generator=g, device="cuda")
    q = q.to(torch.bfloat16) if bf16 else q
    clean = cache
    if scrap:
        cache, clean, tables = _scrap_behind(cache, tables, lengths - window, 0, P)
    return q, cache, lengths, tables, clean, dict(window=window, sinks=0, softcap=cap)


def _d256_prefill_inputs(g, case):
    """(q, cache, lengths, q_starts, tables, clean, masks) of a D256_PREFILL
    case."""
    import torch
    Hq, Hkv, P, C, lens, starts, window, sinks, cap, int4, scrap, bf16 = case
    B = len(lens)
    slots = max(-(-n // P) for n in lens) + 1
    n = B * slots + 1
    cache = (_int4_cache(g, Hkv, n, P, 256, D256_SUBS) if int4
             else _paged_cache(g, Hkv, n, P, 256))
    tables = _tables_for(g, B, slots, n)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q_starts = torch.tensor(starts, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Hq, C, 256), generator=g, device="cuda")
    q = q.to(torch.bfloat16) if bf16 else q
    clean = cache
    if scrap:
        cache, clean, tables = _scrap_behind(cache, tables, q_starts - window + 1, sinks, P)
    return q, cache, lengths, q_starts, tables, clean, dict(window=window, sinks=sinks,
                                                            softcap=cap)


def verify_coverage_inputs(g, case, slots=None):
    """(q, cache, lengths, q_starts, tables, clean, masks) of a
    VERIFY_COVERAGE case, bf16 q, pages of 128 (INT4: D256_SUBS scale
    sub-tiles a page), tables `slots` wide (default one past the longest
    sequence's pages)."""
    import torch
    Hq, Hkv, D, C, lens, window, cap, scrap, int4 = case
    P, B = 128, len(lens)
    slots = slots or max(-(-n // P) for n in lens) + 1
    n = B * slots + 1
    cache = _int4_cache(g, Hkv, n, P, D, D256_SUBS) if int4 else _paged_cache(g, Hkv, n, P, D)
    tables = _tables_for(g, B, slots, n)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q_starts = lengths - C
    q = torch.randn((B, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
    clean = cache
    if scrap:
        cache, clean, tables = _scrap_behind(cache, tables, q_starts - window + 1, 0, P)
    return q, cache, lengths, q_starts, tables, clean, dict(window=window, sinks=0, softcap=cap)


def verify_yardsticks(q, clean, lengths, q_starts, tables, window, *, int4=False):
    """(bytes, operations, SDPA call) of one launch at verify's shape: q
    read and o written in bf16, each sequence's K and V bytes that a row
    can see read once with their pages' scales, lse and the tables; the
    visible (q, key) pairs' bf16 products and exponentials. SDPA (bf16, no
    softcap: it has none) on the same K/V dequantized beforehand (`clean`:
    the scrap page zeroed), each sequence's causal mask and window explicit."""
    import torch
    B, Hq, C, D = q.shape
    Hkv, P = clean[0].shape[0], clean[0].shape[2]
    kpos = torch.arange(tables.shape[1] * P, device=q.device)
    qpos = q_starts.long()[:, None] + torch.arange(C, device=q.device)[None]
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos < lengths.long()[:, None, None])
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window             # [B, C, T]
    pairs = Hq * int(mask.sum())
    keys = int(mask.any(1).sum())
    pages = int(mask.any(1).reshape(B, -1, P).any(-1).sum())
    subs = clean[2].shape[-1] if int4 else 1
    nbytes = (2 * q.numel() * 2 + 2 * keys * Hkv * (D // 2 if int4 else D)
              + 2 * Hkv * pages * subs * 4 + B * Hq * C * 4 + tables.numel() * 4)
    kd = _dense_kv(clean[0], clean[2], tables, Hq)
    vd = _dense_kv(clean[1], clean[3], tables, Hq)
    return (nbytes, {"bf16": 4 * pairs * D, "exp": pairs},
            lambda: _sdpa(q, kd, vd, attn_mask=mask[:, None]))


def verify_sub(g, case, slots=None):
    """The kernels phase's sub-entry of row 10 (row 11 where the case is
    INT4) at one verify shape (a VERIFY_COVERAGE tuple, tables `slots`
    wide): check, kernel / plain / SDPA times, the bound, and the splits
    that prefill_splits cut."""
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    q, cache, lengths, q_starts, tables, clean, masks = verify_coverage_inputs(g, case, slots)
    int4 = case[-1]
    o, p_o, r, launch, plain = _d256_check(q, cache, lengths, tables, q_starts, int4=int4,
                                           clean=clean, **masks)
    B, Hq, C, D = q.shape
    Hkv, P = cache[0].shape[0], cache[0].shape[2]
    nbytes, ops, library = verify_yardsticks(q, clean, lengths, q_starts, tables,
                                             masks["window"], int4=int4)
    return _gemma2_sub(
        o, p_o, r, launch, plain,
        shape={"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "P": P, "C": C,
               "max_pages": tables.shape[1], "q_starts": q_starts.tolist(),
               "lengths": lengths.tolist(), "window": masks["window"],
               "softcap": masks["softcap"], "q": "bfloat16", "int4": int4,
               "save_residuals": True,
               "splits": list(pp.prefill_splits(B, Hkv, C, Hq // Hkv, D, tables.shape[1], P,
                                                 q.dtype))},
        nbytes=nbytes, ops=ops, library=library)


def _coverage_verify():
    """VERIFY_COVERAGE: rows 10 and 11 at verify_step's shape (the split key
    walk) against their plain version, each case from its own generator and
    launched twice."""
    import torch
    ratios = {}
    for i, case in enumerate(VERIFY_COVERAGE):
        g = torch.Generator(device="cuda").manual_seed(380 + i)
        q, cache, lengths, q_starts, tables, clean, masks = verify_coverage_inputs(g, case)
        name = f"paged_prefill_int4_verify_{i}" if case[-1] else f"paged_prefill_verify_{i}"
        ratios[name] = _d256_check(q, cache, lengths, tables, q_starts, int4=case[-1],
                                   clean=clean, **masks)[2]
    return ratios


def _coverage_d256(kinds=("decode", "prefill", "flash"), small=False):
    """D256_DECODE, D256_PREFILL and D256_FLASH: each kernel at d=256
    against its plain version on the card, each case from its own
    generator and launched twice: {case: [output, lse] err_over_tol}.
    small: the cases on pages of fewer than 128 keys only (the faults
    phase's: the Gemma-2-sized ones spend seconds in their plain walks)."""
    import torch
    ratios = {}
    if "decode" in kinds:
        for i, case in enumerate(D256_DECODE):
            if small and case[3] >= 128:
                continue
            g = torch.Generator(device="cuda").manual_seed(300 + i)
            q, cache, lengths, tables, clean, masks = _d256_decode_inputs(g, case)
            name = f"paged_decode_int4_256_{i}" if case[9] else f"decode256_{i}"
            ratios[name] = _d256_check(q, cache, lengths, tables, int4=case[9], clean=clean,
                                       **masks)[2]
    if "prefill" in kinds:
        for i, case in enumerate(D256_PREFILL):
            if small and case[2] >= 128:
                continue
            g = torch.Generator(device="cuda").manual_seed(320 + i)
            q, cache, lengths, q_starts, tables, clean, masks = _d256_prefill_inputs(g, case)
            name = f"paged_prefill_int4_256_{i}" if case[9] else f"paged_prefill256_{i}"
            ratios[name] = _d256_check(q, cache, lengths, tables, q_starts, int4=case[9],
                                       clean=clean, **masks)[2]
    if "flash" in kinds:
        for i, case in enumerate(D256_FLASH):
            g = torch.Generator(device="cuda").manual_seed(340 + i)
            q, k, v, offsets, masks = flash_fwd_coverage_inputs(g, case)
            ratios[f"flash_fwd256_{i}"] = _flash_fwd_check(q, k, v, offsets, **masks)[2]
    return ratios


def _gemma2_sub(out, p_out, ratios, launch, plain, *, shape, nbytes, ops, library):
    """A d=256 sub-entry of a kernel: check, kernel / plain / library times
    (CUDA events), the bound."""
    bms, by = bound(nbytes, ops)
    lib_ms, backend = library()
    return {"max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": max(ratios), "same_bits_twice": float("inf") not in ratios,
            "ok": max(ratios) <= 1.0, "shape": shape,
            "ms": cuda_ms(launch, iters=20), "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, "library_backend": backend}


def _int8p_window_pairs(S, window):
    """(q, kv) pairs of an S-token causal self-attention under a window."""
    return sum(min(i + 1, window) for i in range(S)) if window else S * (S + 1) // 2


def _gemma2_int8(g, mode=0, block_kv=1024, kinds=("full", "sliding", "f32")):
    """An INT8 flash mode at d=256 (row 1's int8 P at serve_hf's prefill,
    block_kv 1024 as pick_blocks gives it; the bf16-P modes at int8_modes'
    calls: mode 1 on the transposed route, block_kv 512 as pick_blocks_t
    gives it, mode 2 on the standard route): Gemma-2's attention
    (GEMMA2_ATTN: 16 q over 8 kv heads, sm_scale 256^-0.5, softcap 50):
    "full", a 2048-token bucket in bf16; "sliding", 8192 tokens under the
    4096 window (quant blocks the window skips); "f32", the full shape with
    f32 q. Each launched twice (the same bits), held to _flash_int8_plain
    within flash_tolerances; SDPA in bf16 (no softcap: it has none) on the
    same K/V with the window in its mask."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    ga = GEMMA2_ATTN
    Hq, Hkv, D, cap = ga["Hq"], ga["Hkv"], ga["D"], ga["softcap"]
    out = {}
    for kind, S, window, dt in (("full", 2048, None, torch.bfloat16),
                                ("sliding", 8192, ga["window"], torch.bfloat16),
                                ("f32", 2048, None, torch.float32)):
        if kind not in kinds:
            continue
        q = torch.randn((1, Hq, S, D), generator=g, device="cuda").to(dt)
        k, v = torch.randn((2, 1, Hkv, S, D), generator=g, device="cuda").to(dt)
        bkv = min(block_kv, S)
        k_i8, ks = quantize_kv_blocks(k, bkv)
        v_i8, vs = quantize_kv_blocks(v, bkv)
        operands = (q, k_i8, ks, v_i8, vs, fa8._offsets(0, 0, 1, q.device))
        kw = dict(sm_scale=D**-0.5, causal=True, kv_len=S, block_kv=bkv, scale_clamp=1e-8,
                  p_scale=127.0, window=window, softcap=cap, sinks=0, mode=mode,
                  save_residuals=True)
        kernel, args, (o, lse), _keep = fa8._flash_int8_launch(*operands, **kw)
        kernel(*args)
        torch.cuda.synchronize()
        same = _same_bits_again(lambda: kernel(*args), (o, lse))
        p_o, p_lse = fa8._flash_int8_plain(*operands, **kw)
        _, _, l = fa8._flash_int8_plain_state(
            *operands, **{x: y for x, y in kw.items() if x != "save_residuals"})
        tol, lse_tol = flash_tolerances(p_o, p_lse, l, v_i8, vs, bkv, mode)
        ratios = [err_over_tol(o, p_o, tol), err_over_tol(lse, p_lse, lse_tol)]
        if not same:
            ratios.append(float("inf"))
        pairs = Hq * _int8p_window_pairs(S, window)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa_kw = dict(attn_mask=mask) if mask is not None else dict(is_causal=True)
        out[kind] = _gemma2_sub(
            o, p_o, ratios, lambda: kernel(*args),
            lambda: fa8._flash_int8_plain(*operands, **kw),
            shape={"B": 1, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "causal": True,
                   "window": window, "softcap": cap, "block_kv": bkv, "q": str(dt)},
            nbytes=(2 * q.numel() * q.element_size() + 2 * k_i8.numel() + 2 * ks.numel() * 4
                    + Hq * S * 4),
            ops={"int8": 2 * (2 if mode == 0 else 1) * pairs * D,
                 "bf16": 0 if mode == 0 else 2 * pairs * D, "exp": pairs},
            library=lambda: _sdpa(qb, kb, vb, enable_gqa=True, **sdpa_kw))
        del q, k, v, qb, kb, vb, k_i8, v_i8, o, p_o, l, tol, mask
        torch.cuda.empty_cache()
    return out


def _cuda_core_bounds(st):
    """The d=256 INT8 flash sub-entries (rows 1-2's "gemma2": full, sliding,
    f32 q) with the bound that their per-score work sets on the CUDA cores:
    harness/sass_count.py's instructions a score of the instance (the built
    library against the copy main() built with that work emptied) x the
    pairs, over every lane of the card at its max SM clock; and the
    kernel's time over it."""
    import torch
    from quantizedmha_tpu_torch.harness import sass_count
    from quantizedmha_tpu_torch.ops import cuda_lib
    per = sass_count.per_score(cuda_lib.library_path("flash_int8_fwd"), st.pop("sass_build"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sass_count.clock_mhz()
    for name, prefix in (("flash_int8_fwd[int8_p]", "flash_int8_int8p_kernelILi256ELb{q}E"),
                         ("flash_int8_fwd[bf16_p]", "flash_int8_bf16p_kernelILi256ELb{q}ELb0E"),
                         ("flash_int8_fwd[bf16_p_f32l]",
                          "flash_int8_bf16p_kernelILi256ELb{q}ELb1E")):
        for sub in st["kernels"].get(name, {}).get("gemma2", {}).values():
            shape = sub["shape"]
            head = prefix.format(q=int(shape["q"] == "torch.bfloat16"))
            n = next(x for k, x in per.items() if k.startswith(head))
            pairs = shape["Hq"] * _int8p_window_pairs(shape["S"], shape["window"])
            sub["instructions_a_score"] = n
            sub["bound_cuda_cores_ms"] = sass_count.cuda_core_ms(pairs, n, sms, mhz)
            sub["over_bound_cuda_cores"] = sub["ms"] / sub["bound_cuda_cores_ms"]


def _gemma2_kernels():
    """Rows 3, 5 (bf16) and 10 (bf16 q) at serve_hybrid's shapes
    (GEMMA2_ATTN), each layer kind: {kernel name: {"full": sub-entry,
    "sliding": sub-entry}}, and rows 6 and 7 at train_gemma2's and, in
    f32, train_gemma2_f32's (_gemma2_bwd); row 10 also at serve_spec's verify shape
    ("verify": VERIFY_COVERAGE[1], a full layer), rows 11 and 12 at
    serve_hybrid_mixed's full layer ("full": the long prompt's last chunk
    in the INT4 frame; the decode batch of four at its final INT4
    lengths), rows 5, 10 and 11 in f32 at serve_gemma2_f32's ("full_f32",
    "sliding_f32": _gemma2_f32). Row 5: a 2048-token bucket, causal, softcap
    (the window of 4096 masks nothing there). Row 10: a 2048-row chunk at
    4096 of context. Row 3: serve_hybrid's decode batch of three (lengths
    364, 1864 and 6064), 64 table slots; the sliding layer's slots behind
    the window on the scrap page. SDPA (bf16, no softcap: it has none) on
    the same K/V, dequantized beforehand for the paged kernels (the scrap
    page zeroed), each layer kind's window in its mask."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    ga = GEMMA2_ATTN
    Hq, Hkv, D, P, cap, win = (ga[x] for x in ("Hq", "Hkv", "D", "P", "softcap", "window"))
    g = torch.Generator(device="cuda").manual_seed(360)
    out = {"flash_fwd[bf16]": {}, "flash_fwd[f32]": {}, "paged_prefill": {},
           "paged_decode": {}, "paged_prefill_int4": {}, "paged_decode_int4": {}}
    S = 2048
    q = torch.randn((1, Hq, S, D), generator=g, device="cuda").to(torch.bfloat16)
    k, v = torch.randn((2, 1, Hkv, S, D), generator=g, device="cuda").to(torch.bfloat16)
    pairs = Hq * _visible_pairs(S, S, True)
    o, p_o, r, _tol, launch, plain = _flash_fwd_check(q, k, v, _offsets(0, 0, 1, q.device),
                                                      causal=True, softcap=cap,
                                                      save_residuals=False)
    out["flash_fwd[bf16]"]["full"] = _gemma2_sub(
        o, p_o, r, launch, plain,
        shape={"B": 1, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "causal": True, "softcap": cap},
        nbytes=(2 * q.numel() + k.numel() + v.numel()) * 2,
        ops={"bf16": 4 * pairs * D, "exp": pairs},
        library=lambda: _sdpa(q, k, v, is_causal=True, enable_gqa=True))
    del q, k, v
    C, q0 = 2048, 4096
    ctx = q0 + C
    n_pages = ctx // P
    for kind, window in (("full", None), ("sliding", win)):
        cache = _paged_cache(g, Hkv, n_pages + 1, P, D)
        tables = (torch.randperm(n_pages, generator=g, device="cuda") + 1)[None].to(torch.int32)
        qc = torch.randn((1, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
        lengths = torch.tensor([ctx], dtype=torch.int32, device="cuda")
        q_starts = torch.tensor([q0], dtype=torch.int32, device="cuda")
        clean = cache
        if window is not None:
            cache, clean, tables = _scrap_behind(cache, tables, q_starts - window + 1, 0, P)
        o, p_o, r, launch, plain = _d256_check(qc, cache, lengths, tables, q_starts, int4=False,
                                               clean=clean, window=window, sinks=0, softcap=cap)
        qpos = q0 + torch.arange(C, device="cuda")
        kpos = torch.arange(ctx, device="cuda")
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        pairs = Hq * int(mask.sum())
        kd = _dense_kv(clean[0], clean[2], tables, Hq)
        vd = _dense_kv(clean[1], clean[3], tables, Hq)
        out["paged_prefill"][kind] = _gemma2_sub(
            o, p_o, r, launch, plain,
            shape={"Hq": Hq, "Hkv": Hkv, "D": D, "P": P, "C": C, "q_start": q0, "lengths": ctx,
                   "window": window, "softcap": cap, "q": "bfloat16", "save_residuals": True},
            nbytes=(2 * qc.numel() * 2 + 2 * int(mask.any(0).sum()) * Hkv * D
                    + 2 * Hkv * n_pages * 4 + Hq * C * 4),
            ops={"bf16": 4 * pairs * D, "exp": pairs},
            library=lambda: _sdpa(qc, kd, vd, attn_mask=mask))
        del kd, vd, cache, clean
    for kind, window in (("full", None), ("sliding", win)):
        case = (3, Hq, Hkv, P, window, cap, 64, (364, 1864, 6064), True, False,
                window is not None)
        q, cache, lengths, tables, clean, masks = _d256_decode_inputs(g, case)
        o, p_o, r, launch, plain = _d256_check(q, cache, lengths, tables, int4=False,
                                               clean=clean, **masks)
        lens = lengths.long()
        seen = (lens if window is None else torch.clamp(lens, max=window)).sum().item()
        out["paged_decode"][kind] = _gemma2_sub(
            o, p_o, r, launch, plain,
            shape={"B": 3, "Hq": Hq, "Hkv": Hkv, "D": D, "page": P, "max_pages": 64,
                   "lengths": lengths.tolist(), "window": window, "softcap": cap,
                   "q": "bfloat16"},
            nbytes=q.numel() * 2 * 2 + 2 * seen * Hkv * D + 3 * Hq * 4,
            ops={"fp32": 2 * 2 * seen * Hq * D, "exp": seen * Hq},
            library=lambda: _sdpa_decode(q, *clean, lengths, tables, window=window))
    _gemma2_verify_and_int4(g, out)
    _gemma2_f32(torch.Generator(device="cuda").manual_seed(363), out)
    out["flash_int8_fwd[int8_p]"] = _gemma2_int8(torch.Generator(device="cuda").manual_seed(361))
    out["flash_int8_fwd[bf16_p]"] = _gemma2_int8(torch.Generator(device="cuda").manual_seed(364),
                                                 mode=1, block_kv=512)
    out["flash_int8_fwd[bf16_p_f32l]"] = _gemma2_int8(
        torch.Generator(device="cuda").manual_seed(365), mode=2, kinds=("full",))
    out.update(_gemma2_bwd(torch.Generator(device="cuda").manual_seed(362)))
    return out


def _gemma2_verify_and_int4(g, out):
    """_gemma2_kernels' verify entry of row 10 and full entries of rows 11
    and 12. SDPA (bf16, no softcap) on the same K/V dequantized beforehand,
    each sequence's causal mask explicit."""
    import torch
    ga = GEMMA2_ATTN
    Hq, Hkv, D, P, cap = (ga[x] for x in ("Hq", "Hkv", "D", "P", "softcap"))
    out["paged_prefill"]["verify"] = verify_sub(g, VERIFY_COVERAGE[1])
    subs, bnd = D256_SUBS, SERVE_HYBRID_MIXED["mixed"]["boundary_tokens"]
    C, q0 = 2048, 4096 - bnd
    ctx = q0 + C
    n_pages = -(-ctx // P)
    cache = _int4_cache(g, Hkv, n_pages + 1, P, D, subs)
    tables = _tables_for(g, 1, n_pages, n_pages + 1)
    qc = torch.randn((1, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor([ctx], dtype=torch.int32, device="cuda")
    q_starts = torch.tensor([q0], dtype=torch.int32, device="cuda")
    o, p_o, r, launch, plain = _d256_check(qc, cache, lengths, tables, q_starts, int4=True,
                                           clean=cache, window=None, sinks=0, softcap=cap)
    kd = _dense_kv(cache[0], cache[2], tables, Hq)[:, :, :ctx]
    vd = _dense_kv(cache[1], cache[3], tables, Hq)[:, :, :ctx]
    mask = (torch.arange(ctx, device="cuda")[None, :]
            <= q0 + torch.arange(C, device="cuda")[:, None])
    pairs = Hq * (C * q0 + C * (C + 1) // 2)
    out["paged_prefill_int4"]["full"] = _gemma2_sub(
        o, p_o, r, launch, plain,
        shape={"Hq": Hq, "Hkv": Hkv, "D": D, "P": P, "subs": subs, "C": C, "q_start": q0,
               "lengths": ctx, "window": None, "softcap": cap, "q": "bfloat16",
               "save_residuals": True},
        nbytes=(2 * qc.numel() * 2 + 2 * ctx * Hkv * D // 2 + 2 * Hkv * n_pages * subs * 4
                + Hq * C * 4 + tables.numel() * 4),
        ops={"bf16": 4 * pairs * D, "exp": pairs},
        library=lambda: _sdpa(qc, kd, vd, attn_mask=mask))
    del kd, vd, cache, qc
    case = (4, Hq, Hkv, P, None, cap, 64, (0, 108, 1608, 5808), True, True, False)
    q, cache, lengths, tables, clean, masks = _d256_decode_inputs(g, case)
    o, p_o, r, launch, plain = _d256_check(q, cache, lengths, tables, int4=True, clean=clean,
                                           **masks)
    ctx = int(lengths.sum())
    pages = sum(-(-int(n) // P) for n in lengths.tolist())
    out["paged_decode_int4"]["full"] = _gemma2_sub(
        o, p_o, r, launch, plain,
        shape={"B": 4, "Hq": Hq, "Hkv": Hkv, "D": D, "page": P, "subs": subs,
               "max_pages": 64, "lengths": lengths.tolist(), "window": None, "softcap": cap,
               "q": "bfloat16", "save_residuals": True},
        nbytes=(q.numel() * 2 * 2 + 4 * Hq * 4 + 2 * ctx * Hkv * D // 2
                + 2 * pages * Hkv * subs * 4 + tables.numel() * 4),
        ops={"fp32": 2 * 2 * ctx * Hq * D, "exp": ctx * Hq},
        library=lambda: _sdpa_decode(q, *clean, lengths, tables))


def _f32_bounds(sub, nbytes, passes, pairs, D, products=2):
    """Complete an f32 d=256 sub-entry whose bound_ms counts `passes` bf16
    passes on the tensor cores: the bound on the CUDA cores' f32 FMAs (the
    kernel's own route, `products` products of 2·D flop a visible pair)
    beside it, and the kernel's time over each."""
    cc_ms, cc_by = bound(nbytes, {"fp32": 2 * products * pairs * D, "exp": pairs})
    sub.update({"bound_tensor_core_passes": passes, "bound_cuda_cores_ms": cc_ms,
                "bound_cuda_cores_by": cc_by, "over_bound": sub["ms"] / sub["bound_ms"],
                "over_bound_cuda_cores": sub["ms"] / cc_ms})


def _gemma2_f32(g, out):
    """Rows 5, 10, 11, 3 and 12 in f32 at head_dim 256, serve_gemma2_f32's
    shapes (GEMMA2_ATTN), into _gemma2_kernels' entries: row 5 ("flash_fwd[f32]")
    "full_f32", a 2048-token bucket, causal, softcap 50, and "sliding_f32",
    8192 tokens under the 4096 window (the tiles wholly behind it
    skipped); rows 10 and 11 with f32 q, "full_f32" and "sliding_f32", a
    2048-row chunk at 4096 of context over INT8 pages or INT4 pages of
    D256_SUBS sub-tiles (the sliding layer's slots behind the window on the
    scrap page). Each launched twice (the same bits) and held to its plain
    version. Bound (_f32_bounds): the card's best route for the same f32
    function, bf16 passes on the tensor cores (six for row 5, as its d <= 128
    route runs; three for rows 10-11, whose int8 / int4 K and V are exact in
    bf16), or the bytes, whichever is larger; beside it the kernel's own
    route, the f32 FMAs on the CUDA cores ("bound_cuda_cores_ms"), 4·d
    operations a visible pair. Rows 3 and 12 with f32 q, "full_f32": the
    decode batches of their bf16-q "full" entries (three INT8 sequences of
    364, 1864 and 6064 tokens; four INT4 of 0 to 5808), bound by their
    bytes. Library: SDPA in f32 (TF32 off) on the same K/V, expanded to the
    q heads (and dequantized, for the paged kernels) beforehand, each
    kind's window in its mask; the backend that took it is named."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    ga = GEMMA2_ATTN
    Hq, Hkv, D, P, cap, win = (ga[x] for x in ("Hq", "Hkv", "D", "P", "softcap", "window"))
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, S, window in (("full_f32", 2048, None), ("sliding_f32", 8192, win)):
        q = torch.randn((1, Hq, S, D), generator=g, device="cuda")
        k, v = torch.randn((2, 1, Hkv, S, D), generator=g, device="cuda")
        o, p_o, r, _tol, launch, plain = _flash_fwd_check(
            q, k, v, _offsets(0, 0, 1, q.device), causal=True, window=window, softcap=cap,
            save_residuals=False)
        pairs = Hq * _int8p_window_pairs(S, window)
        sdpa_kw = dict(is_causal=True)
        if window is not None:
            i = torch.arange(S, device="cuda")
            sdpa_kw = dict(attn_mask=(i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window))
        # K/V expanded to the q heads beforehand (untimed): SDPA's fused f32
        # kernels refuse a GQA layout and would fall back to its math path.
        ke, ve = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
        out["flash_fwd[f32]"][kind] = _gemma2_sub(
            o, p_o, r, launch, plain,
            shape={"B": 1, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "causal": True,
                   "window": window, "softcap": cap, "dtype": "float32"},
            nbytes=nbytes, ops={"bf16": 6 * 4 * pairs * D, "exp": pairs},
            library=lambda: _sdpa(q, ke, ve, **sdpa_kw))
        _f32_bounds(out["flash_fwd[f32]"][kind], nbytes, 6, pairs, D)
        del q, k, v, ke, ve, o, p_o, sdpa_kw
        torch.cuda.empty_cache()
    C, q0 = 2048, 4096
    ctx = q0 + C
    n_pages = ctx // P
    for name, int4 in (("paged_prefill", False), ("paged_prefill_int4", True)):
        for kind, window in (("full_f32", None), ("sliding_f32", win)):
            cache = (_int4_cache(g, Hkv, n_pages + 1, P, D, D256_SUBS) if int4
                     else _paged_cache(g, Hkv, n_pages + 1, P, D))
            tables = _tables_for(g, 1, n_pages, n_pages + 1)
            qc = torch.randn((1, Hq, C, D), generator=g, device="cuda")
            lengths = torch.tensor([ctx], dtype=torch.int32, device="cuda")
            q_starts = torch.tensor([q0], dtype=torch.int32, device="cuda")
            clean = cache
            if window is not None:
                cache, clean, tables = _scrap_behind(cache, tables, q_starts - window + 1, 0, P)
            o, p_o, r, launch, plain = _d256_check(qc, cache, lengths, tables, q_starts,
                                                   int4=int4, clean=clean, window=window,
                                                   sinks=0, softcap=cap)
            qpos = q0 + torch.arange(C, device="cuda")
            kpos = torch.arange(ctx, device="cuda")
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            pairs = Hq * int(mask.sum())
            keys = int(mask.any(0).sum())
            kd = _dense_kv(clean[0], clean[2], tables, Hq, dtype=torch.float32)
            vd = _dense_kv(clean[1], clean[3], tables, Hq, dtype=torch.float32)
            row_bytes = D // 2 if int4 else D
            subs = D256_SUBS if int4 else 1
            nbytes = (2 * qc.numel() * 4 + 2 * keys * Hkv * row_bytes
                      + 2 * Hkv * -(-keys // P) * subs * 4 + Hq * C * 4)
            out[name][kind] = _gemma2_sub(
                o, p_o, r, launch, plain,
                shape={"Hq": Hq, "Hkv": Hkv, "D": D, "P": P, "C": C, "q_start": q0,
                       "lengths": ctx, "window": window, "softcap": cap, "q": "float32",
                       "subs": subs, "save_residuals": True},
                nbytes=nbytes, ops={"bf16": 3 * 4 * pairs * D, "exp": pairs},
                library=lambda: _sdpa(qc, kd, vd, attn_mask=mask))
            _f32_bounds(out[name][kind], nbytes, 3, pairs, D)
            del kd, vd, cache, clean, qc, o, p_o, mask
            torch.cuda.empty_cache()
    for name, int4, lens in (("paged_decode", False, (364, 1864, 6064)),
                             ("paged_decode_int4", True, (0, 108, 1608, 5808))):
        case = (len(lens), Hq, Hkv, P, None, cap, 64, lens, False, int4, False)
        q, cache, lengths, tables, clean, masks = _d256_decode_inputs(g, case)
        o, p_o, r, launch, plain = _d256_check(q, cache, lengths, tables, int4=int4, clean=clean,
                                               **masks)
        ctx = int(lengths.sum())
        pages = sum(-(-int(n) // P) for n in lengths.tolist())
        subs = D256_SUBS if int4 else 1
        out[name]["full_f32"] = _gemma2_sub(
            o, p_o, r, launch, plain,
            shape={"B": len(lens), "Hq": Hq, "Hkv": Hkv, "D": D, "page": P, "subs": subs,
                   "max_pages": 64, "lengths": list(lens), "window": None, "softcap": cap,
                   "q": "float32", "save_residuals": True},
            nbytes=(q.numel() * 4 * 2 + len(lens) * Hq * 4 + 2 * ctx * Hkv * (D // 2 if int4 else D)
                    + 2 * pages * Hkv * subs * 4 + tables.numel() * 4),
            ops={"fp32": 2 * 2 * ctx * Hq * D, "exp": ctx * Hq},
            library=lambda: _sdpa_decode(q, *clean, lengths, tables, dtype=torch.float32))
        del q, cache, clean, o, p_o
        torch.cuda.empty_cache()


def _coverage():
    """Every FLASH_COVERAGE / DECODE_COVERAGE case, kernel against plain on
    the card with output and lse checked; returns the summary entry, with
    each case's [output, lse] error over its tolerance."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(5)
    ratios = _flash_coverage_ratios(g)
    failed = [k for k, x in ratios.items() if max(x) > 1.0]
    r = _decode_coverage_ratios(g)
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    r, f = _coverage_float(g)
    ratios.update(r)
    failed += f
    r = _coverage_int4(g)
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    composites = _mixed_composites(g)
    failed += [k for k, c in composites.items() if c["err_over_tol"] > 1.0]
    r = _coverage_bwd(g)
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    r = _coverage_d256()
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    r = _coverage_verify()
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    return {"flash_cases": len(FLASH_COVERAGE), "decode_cases": len(DECODE_COVERAGE),
            "d256_cases": len(D256_DECODE) + len(D256_PREFILL) + len(D256_FLASH),
            "verify_cases": len(VERIFY_COVERAGE),
            "flash_fwd_cases": len(FLASH_FWD_COVERAGE),
            "flash_bwd_cases": len(FLASH_BWD_COVERAGE),
            "paged_prefill_cases": len(PAGED_PREFILL_COVERAGE),
            "int4_cases": len(DECODE_INT4_COVERAGE) + len(PREFILL_INT4_COVERAGE),
            "err_over_tol": ratios, "mixed_composites": composites, "failed": failed,
            "ok": not failed}


# --- INT4 pages (the mixed cache's bulk): rows 11 and 12 -------------------

# serve_mixed's shapes: Llama-3-8B heads, page 128, 4 scale sub-tiles a page,
# the INT8 region the first 256 positions, an INT4 table of 64 slots.
MIXED_MAIN = dict(Hq=32, Hkv=8, D=128, P=128, subs=4, boundary=256, max_pages4=64)


def _int4_cache(g, Hkv, num_pages, P, D, subs):
    """Random nibble-packed pages (every byte value) and per-sub-tile
    scales [Hkv, num_pages, subs] on the card."""
    import torch
    k_pages, v_pages = torch.randint(-128, 128, (2, Hkv, num_pages, P, D // 2), generator=g,
                                     device="cuda", dtype=torch.int8)
    k_scales, v_scales = torch.rand((2, Hkv, num_pages, subs), generator=g, device="cuda") * 0.2 + 0.1
    return k_pages, v_pages, k_scales, v_scales


def _tables_for(g, B, max_pages, num_pages):
    """[B, max_pages] tables of distinct random pages past scrap page 0."""
    import torch
    perm = torch.randperm(num_pages - 1, generator=g, device="cuda")[:B * max_pages] + 1
    return perm.reshape(B, max_pages).to(torch.int32)


def _int4_check(q, cache, lengths, tables, q_starts=None, *, window=None, sinks=0,
                softcap=None):
    """One INT4 launch with lse, decode (q [B, Hq, D]) or prefill (q [B,
    Hq, C, D], q_starts), against its plain version: (kernel output, plain
    output, [output, lse] err_over_tol, output tolerance, launch, plain
    call, plain lse, lse tolerance). A decode launch and a bf16 prefill
    launch run twice, as in _paged_prefill_check."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, window=window, softcap=softcap, sinks=sinks, save_residuals=True)
    w_abs = None
    if q_starts is None:
        operands = (q, *cache, lengths, tables)
        launch_fn, plain_fn = dec._paged_decode_launch, dec._paged_decode_int4_plain
    else:
        operands = (q, *cache, lengths, q_starts, tables)
        launch_fn, plain_fn = pp._paged_prefill_launch, pp._paged_prefill_int4_plain
        w_abs = prefill_w_abs(q, cache, lengths, q_starts, tables, int4=True, **kw)
    kernel, args, (out, lse), _operands = launch_fn(*operands, int4=True, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = ((q_starts is not None and w_abs is None)
            or _same_bits_again(lambda: kernel(*args), (out, lse)))
    p_out, p_lse = plain_fn(*operands, **kw)
    tol, lse_tol = int4_tolerances(q, *cache, p_out, p_lse, sm_scale=sm, softcap=softcap,
                                   w_abs=w_abs)
    ratios = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
    if not same:
        ratios.append(float("inf"))
    return (out, p_out, ratios, tol, _keeping(kernel, args, _operands),
            lambda: plain_fn(*operands, **kw), p_lse, lse_tol)


def _int4_decode_main_inputs(g):
    """serve_mixed's decode at batch 8: INT4 contexts of 1.7k-7.7k tokens
    (lengths less the 256-token INT8 region) through 64-slot tables."""
    import torch
    m = MIXED_MAIN
    B = 8
    cache = _int4_cache(g, m["Hkv"], B * m["max_pages4"] + 1, m["P"], m["D"], m["subs"])
    tables = _tables_for(g, B, m["max_pages4"], B * m["max_pages4"] + 1)
    lengths = torch.randint(1700, 7701, (B,), generator=g, device="cuda", dtype=torch.int32)
    q = torch.randn((B, m["Hq"], m["D"]), generator=g, device="cuda").to(torch.bfloat16)
    return q, cache, lengths, tables


def _int4_prefill_main_inputs(g):
    """serve_mixed's heaviest chunk in the INT4 frame: 2048 rows at 4096 of
    context (q_start 4096 - 256, length 6144 - 256), bf16 q."""
    import torch
    m = MIXED_MAIN
    C, q0 = 2048, 4096 - m["boundary"]
    n_pages = -(-(q0 + C) // m["P"])
    cache = _int4_cache(g, m["Hkv"], n_pages + 1, m["P"], m["D"], m["subs"])
    tables = _tables_for(g, 1, n_pages, n_pages + 1)
    q = torch.randn((1, m["Hq"], C, m["D"]), generator=g, device="cuda").to(torch.bfloat16)
    return (q, cache, torch.tensor([q0 + C], dtype=torch.int32, device="cuda"),
            tables, torch.tensor([q0], dtype=torch.int32, device="cuda"))


def _int4_decode_case(g):
    """Row 12 at serve_mixed's decode shape: check, kernel / plain / SDPA
    times, the bound (the INT4 bytes of the context once, q, o, lse)."""
    from quantizedmha_tpu_torch.ops.decode import decode_splits
    m = MIXED_MAIN
    q, cache, lengths, tables = _int4_decode_main_inputs(g)
    out, p_out, ratios, tol, launch, plain, *_ = _int4_check(q, cache, lengths, tables)
    ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    lib_ms, backend = _sdpa_decode(q, *cache, lengths, tables)
    B, Hq, D = q.shape
    ctx = int(lengths.sum().item())
    pages = sum(-(-int(n) // m["P"]) for n in lengths.tolist())
    nbytes = (q.numel() * 2 * 2 + B * Hq * 4 + 2 * ctx * m["Hkv"] * D // 2
              + 2 * pages * m["Hkv"] * m["subs"] * 4 + B * 4 + tables.numel() * 4)
    bms, by = bound(nbytes, {"fp32": 2 * 2 * ctx * Hq * D, "exp": ctx * Hq})
    splits = decode_splits(B, m["Hkv"], m["max_pages4"], m["P"])
    return {"name": "paged_decode_int4", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_decode.cu",
            "replaces": "quantizedmha_tpu/ops/decode.py:897", "launches": None,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": max(ratios), "tol_range": [tol.min().item(), tol.max().item()],
            "ok": max(ratios) <= 1.0, "same_bits_twice": len(ratios) == 2,
            "shape": {"B": B, "Hq": Hq, "Hkv": m["Hkv"], "D": D, "page": m["P"],
                      "subs": m["subs"], "max_pages": m["max_pages4"], "splits": list(splits),
                      "lengths": lengths.tolist(), "save_residuals": True, "q": "bfloat16"},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


def _int4_prefill_case(g):
    """Row 11 at serve_mixed's heaviest chunk: check, kernel / plain / SDPA
    times (SDPA on the same K/V dequantized to bf16, causal mask explicit),
    the bound (bf16 operations of the visible pairs: both products on the
    tensor cores)."""
    import torch
    m = MIXED_MAIN
    q, cache, lengths, tables, q_starts = _int4_prefill_main_inputs(g)
    out, p_out, ratios, tol, launch, plain, *_ = _int4_check(q, cache, lengths, tables, q_starts)
    ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    B, Hq, C, D = q.shape
    q0, ctx = int(q_starts[0]), int(lengths[0])
    kd = _dense_kv(cache[0], cache[2], tables, Hq)[:, :, :ctx]
    vd = _dense_kv(cache[1], cache[3], tables, Hq)[:, :, :ctx]
    mask = (torch.arange(ctx, device="cuda")[None, :]
            <= q0 + torch.arange(C, device="cuda")[:, None])
    lib_ms, backend = _sdpa(q, kd, vd, attn_mask=mask)
    del kd, vd
    pairs = Hq * (C * q0 + C * (C + 1) // 2)
    n_pages = tables.shape[1]
    nbytes = (2 * q.numel() * 2 + 2 * ctx * m["Hkv"] * D // 2
              + 2 * m["Hkv"] * n_pages * m["subs"] * 4 + tables.numel() * 4 + Hq * C * 4)
    bms, by = bound(nbytes, {"bf16": 4 * pairs * D, "exp": pairs})
    return {"name": "paged_prefill_int4", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": "quantizedmha_tpu/ops/paged_prefill.py:323", "launches": None,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": max(ratios), "tol_range": [tol.min().item(), tol.max().item()],
            "ok": max(ratios) <= 1.0,
            "shape": {"Hq": Hq, "Hkv": m["Hkv"], "D": D, "P": m["P"], "subs": m["subs"],
                      "C": C, "q_start": q0, "lengths": ctx, "save_residuals": True,
                      "q": "bfloat16"},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


# Small INT4 shapes off the main paths: subs 1 and 4, window, window + sinks,
# softcap, Hkv 1 and 2, GQA groups 4, 3 and 8, every head dim, both q dtypes,
# an empty sequence (length 0) in every decode case, and prefill chunks whose
# q_start is negative and straddles 0 inside a q tile.
#   (B, Hq, Hkv, D, page, subs, window, sinks, softcap, bf16 q, table slots,
#    lengths (None: drawn from 1 to a full table; the first is set to 0))
# The last four hold 20-40 slots, several splits, as DECODE_COVERAGE's.
DECODE_INT4_COVERAGE = (
    (3, 8, 2, 32, 16, 1, None, 0, None, False, 6, None),
    (3, 4, 1, 64, 32, 4, 20, 3, 50.0, True, 6, None),
    (2, 8, 2, 128, 16, 4, 7, 0, None, False, 6, None),
    (4, 8, 1, 128, 64, 2, None, 0, 30.0, True, 6, None),
    (3, 8, 2, 64, 16, 4, 100, 5, None, True, 40, (0, 640, 300)),
    (3, 4, 1, 128, 32, 2, None, 0, 20.0, False, 24, (0, 1, 700)),
    (2, 32, 1, 128, 128, 4, None, 0, None, True, 24, (0, 2900)),
    (4, 8, 2, 32, 16, 1, None, 0, None, False, 32, (0, 5, 40, 512)),
)
#   (Hq, Hkv, D, page, subs, C, lengths, q_starts, window, sinks, softcap, bf16 q)
# The last three (bf16, tensor cores): d=32 on 16-key pages; GQA 8 (Hkv 1)
# on 32-key pages of 4 sub-tiles with negative q_starts; window + sinks.
PREFILL_INT4_COVERAGE = (
    (8, 2, 32, 16, 1, 40, (40, 90), (0, 50), None, 0, None, False),
    (4, 1, 64, 32, 4, 33, (100, 20), (67, -13), 30, 3, None, True),
    (8, 2, 128, 128, 4, 70, (200, 0, 50), (130, -70, -20), None, 0, 10.0, True),
    (6, 2, 64, 64, 2, 20, (300,), (280,), 64, 0, None, False),
    (32, 8, 128, 128, 4, 130, (900, 60), (770, -70), None, 0, None, True),
    (8, 2, 32, 16, 2, 40, (40, 90), (0, 50), None, 0, None, True),
    (8, 1, 64, 32, 4, 60, (100, 30, 0), (40, -30, -60), None, 0, None, True),
    (4, 2, 128, 64, 2, 120, (400,), (280,), 90, 4, 15.0, True),
)


def _coverage_int4(g):
    """DECODE_INT4_COVERAGE and PREFILL_INT4_COVERAGE: kernel against plain
    on the card, {case: [output, lse] err_over_tol}."""
    ratios = {}
    for i, case in enumerate(DECODE_INT4_COVERAGE):
        q, cache, lengths, tables, masks = decode_int4_coverage_inputs(g, case)
        ratios[f"paged_decode_int4_{i}"] = _int4_check(q, cache, lengths, tables, **masks)[2]
    for i, case in enumerate(PREFILL_INT4_COVERAGE):
        q, cache, lengths, q_starts, tables, masks = paged_prefill_coverage_inputs(
            g, case, int4=True)
        ratios[f"paged_prefill_int4_{i}"] = _int4_check(q, cache, lengths, tables, q_starts,
                                                        **masks)[2]
    return ratios


def decode_int4_coverage_inputs(g, case):
    """(q, cache, lengths, tables, masks) of one DECODE_INT4_COVERAGE case
    on the card (the first sequence empty)."""
    import torch
    B, Hq, Hkv, D, P, subs, window, sinks, cap, bf16, max_pages, lens = case
    cache = _int4_cache(g, Hkv, B * max_pages + 1, P, D, subs)
    tables = _tables_for(g, B, max_pages, B * max_pages + 1)
    lengths = torch.randint(1, P * max_pages + 1, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
    if lens is not None:
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    lengths[0] = 0
    q = torch.randn((B, Hq, D), generator=g, device="cuda")
    q = q.to(torch.bfloat16) if bf16 else q
    return q, cache, lengths, tables, dict(window=window, sinks=sinks, softcap=cap)


def paged_prefill_coverage_inputs(g, case, *, int4=False, q_dtype=None):
    """(q, cache, lengths, q_starts, tables, masks) of one
    PAGED_PREFILL_COVERAGE case (INT8 pages) or, with int4,
    PREFILL_INT4_COVERAGE case on the card; q in q_dtype when given, else
    as the case says."""
    import torch
    if int4:
        Hq, Hkv, D, P, subs, C, lengths, q_starts, window, sinks, cap, bf16 = case
    else:
        Hq, Hkv, D, P, C, lengths, q_starts, window, sinks, cap, bf16 = case
    B = len(lengths)
    max_pages = max(-(-n // P) for n in lengths) + 1
    if int4:
        cache = _int4_cache(g, Hkv, B * max_pages + 1, P, D, subs)
        tables = _tables_for(g, B, max_pages, B * max_pages + 1)
    else:
        cache = _paged_cache(g, Hkv, B * max_pages + 1, P, D)
        tables = (torch.randperm(B * max_pages, generator=g, device="cuda") + 1).reshape(
            B, max_pages).to(torch.int32)
    q = torch.randn((B, Hq, C, D), generator=g, device="cuda")
    q = q.to(q_dtype or (torch.bfloat16 if bf16 else torch.float32))
    return (q, cache, torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            torch.tensor(q_starts, dtype=torch.int32, device="cuda"), tables,
            dict(window=window, sinks=sinks, softcap=cap))


def _mixed_composites(g):
    """mixed_paged_decode_attention and mixed_paged_prefill_attention on the
    card (two kernels each and the merge) against their plain compositions
    (the plain INT8 and INT4 walks, the same merge), held within
    merge_tolerance of the partials' tolerances; and the decode composite's
    largest deviation from float attention over the dequantized mixed cache
    (scripts/run13_mixed_kv.py's check), printed."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.parallel.combine import merge_two_partials
    from quantizedmha_tpu_torch.serving.mixed_kv import (
        MixedPagedKVState,
        mixed_paged_decode_attention,
        mixed_paged_prefill_attention,
    )
    m = MIXED_MAIN
    Hq, Hkv, D, P, bnd = m["Hq"], m["Hkv"], m["D"], m["P"], m["boundary"]
    bp, mp4, B = bnd // P, 16, 8
    c8 = _paged_cache(g, Hkv, B * bp + 1, P, D)
    c4 = _int4_cache(g, Hkv, B * mp4 + 1, P, D, m["subs"])
    state = MixedPagedKVState(*c8, *c4)
    t8, t4 = _tables_for(g, B, bp, B * bp + 1), _tables_for(g, B, mp4, B * mp4 + 1)
    lengths = torch.tensor([100, 256, 257, 300, 900, 1500, 2000, 2304], dtype=torch.int32,
                           device="cuda")
    sm = D**-0.5
    kw = dict(sm_scale=sm, window=None, softcap=None, sinks=0, save_residuals=True)
    out = {}

    def held(name, got, parts, tols):
        (o8, l8), (o4, l4) = parts
        plain = merge_two_partials(o8, l8, o4, l4)[0]
        tol = merge_tolerance(plain, (l8, l4), (o8, o4), (tols[0][0], tols[1][0]),
                              (tols[0][1], tols[1][1]))
        out[name] = {"err_over_tol": err_over_tol(got, plain, tol),
                     "max_abs_err": (got.float() - plain.float()).abs().max().item()}
        return plain

    # Decode: lengths below, at and past the boundary, bf16 q.
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    got = mixed_paged_decode_attention(q, state, lengths, t8, t4, bnd)
    len8, len4 = lengths.clamp(max=bnd), (lengths - bnd).clamp(min=0)
    p8 = dec._paged_decode_plain(q, *c8, len8, t8, **kw)
    p4 = dec._paged_decode_int4_plain(q, *c4, len4, t4, **kw)
    tol8 = decode_tolerance(p8[0], c8[1], c8[3])
    lse_tol8 = 1e-5 + 1e-6 * torch.nan_to_num(p8[1].double().abs(), posinf=0.0)
    tols4 = int4_tolerances(q, *c4, *p4, sm_scale=sm, softcap=None)
    held("mixed_decode", got, (p8, p4), ((tol8, lse_tol8), tols4))
    # Float attention over the dequantized mixed cache, one sequence at a time.
    f32 = torch.float32
    k = torch.cat([_dense_kv(c8[0], c8[2], t8, Hq, f32), _dense_kv(c4[0], c4[2], t4, Hq, f32)],
                  dim=2)
    v = torch.cat([_dense_kv(c8[1], c8[3], t8, Hq, f32), _dense_kv(c4[1], c4[3], t4, Hq, f32)],
                  dim=2)
    dev = 0.0
    for b in range(B):
        n = int(lengths[b])
        n8 = min(n, bnd)
        keep = torch.cat([torch.arange(bnd, device="cuda") < n8,
                          torch.arange(k.shape[2] - bnd, device="cuda") < n - n8])
        s = (q[b].float()[:, None] @ k[b, :, keep].transpose(-1, -2))[:, 0] * sm
        ref = (torch.softmax(s, dim=-1)[:, None] @ v[b, :, keep])[:, 0]
        dev = max(dev, (got[b].float() - ref).abs().max().item())
    out["mixed_decode"]["max_abs_dev_vs_float_dequant"] = dev
    del k, v
    # Prefill: one chunk of 512 rows at 128 (spanning the boundary: its INT4
    # rows start at -128), one past it at 1024, bf16 q.
    C = 512
    q = torch.randn((2, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
    starts = torch.tensor([128, 1024], dtype=torch.int32, device="cuda")
    lengths = starts + C
    got = mixed_paged_prefill_attention(q, state, lengths, starts, t8[:2], t4[:2], bnd)
    len8, len4 = lengths.clamp(max=bnd), (lengths - bnd).clamp(min=0)
    p8 = pp._paged_prefill_plain(q, *c8, len8, starts, t8[:2], **kw)
    p4 = pp._paged_prefill_int4_plain(q, *c4, len4, starts - bnd, t4[:2], **kw)
    w8 = prefill_w_abs(q, c8, len8, starts, t8[:2], **kw)
    w4 = prefill_w_abs(q, c4, len4, starts - bnd, t4[:2], int4=True, **kw)
    tols8 = paged_prefill_tolerances(q, *c8, *p8, sm_scale=sm, softcap=None, w_abs=w8)
    tols4 = int4_tolerances(q, *c4, *p4, sm_scale=sm, softcap=None, w_abs=w4)
    held("mixed_prefill", got, (p8, p4), (tols8, tols4))
    return out


# The four fused w4a16 matmuls of one Llama-3-8B decoder layer (serve_w4):
# (name, in, out), group 128, halves packing, bf16 x at the serve_w4 batches.
W4_MAIN = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gateup", 4096, 28672),
           ("w_down", 14336, 4096))
W4_BATCHES = (8, 1, 32, 64)  # the first is the entry's headline; 64: serve_w4's prefill
# Off the main path: pairs packing, f32 x, groups 32/64, R = 5, 17 and 64,
# out widths with a tail (and not a multiple of 8 or 16: byte-wise loads),
# a layer > 0 of a 3-layer stack; bf16 x past 64 rows (two row tiles),
# scale groups of one k16 step (four a stage) and of fewer packed rows than
# a k16 step (the CUDA-core kernel takes bf16 x there).
#   (R, in, out, group, packing, f32 x, stacked layer or None)
W4_COVERAGE = (
    (5, 1024, 1000, 64, "pairs", False, None),
    (64, 2048, 768, 128, "halves", False, None),
    (3, 512, 333, 32, "pairs", True, None),
    (2, 768, 520, 64, "halves", True, 2),
    (1, 14336, 264, 128, "pairs", False, 1),
    (17, 256, 96, 32, "halves", False, None),
    (100, 1024, 776, 128, "pairs", False, None),
    (9, 768, 272, 32, "pairs", False, None),
    (4, 512, 200, 8, "halves", False, None),
)


def _int4pack_library(x, w, golden):
    """torch._weight_int4pack_mm on the same weights in its layout (q + 8
    unsigned, [out, in/2] bytes with the even input row in the high nibble,
    bf16 scales, zero point 0; it computes (q' - 8) * s + z): (ms, its
    relative RMS error against the f32 golden, why there is no time). The
    port never calls it: it is the yardstick beside the kernel."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import unpack_weight4
    try:
        q = (unpack_weight4(w).to(torch.int32) + 8).t().contiguous()
        wpk = torch._convert_weight_to_int4pack(((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([w.scale, torch.zeros_like(w.scale)], dim=-1).to(torch.bfloat16)

        def fn():
            return torch._weight_int4pack_mm(x, wpk, w.group, sz.contiguous())
        got = fn()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError, TypeError) as e:
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    rel = ((got.float() - golden).norm() / golden.norm()).item()
    return cuda_ms(fn, iters=50), rel, None


def _w4_case(x, w, layer=None, *, timed):
    """One w4_matmul case on the card: the wrapper's output (launched twice:
    the two must be bitwise equal) against the plain version and the f32
    golden; with timed, kernel / plain / library times and the bound."""
    import torch
    from quantizedmha_tpu_torch.ops import w4_matmul as w4
    from quantizedmha_tpu_torch.quant.weights import dequantize_weight4
    view = w if layer is None else w.layer(layer)
    kw = dict(group=w.group, packing=w.packing)
    out = w4.w4_matmul(x, w.packed, w.scale, layer=layer, **kw)
    again = w4.w4_matmul(x, w.packed, w.scale, layer=layer, **kw)
    torch.cuda.synchronize()
    plain = w4._w4_matmul_plain(x, view.packed, view.scale, **kw)
    golden = x.float() @ dequantize_weight4(view)
    R, in_dim = x.shape
    n = view.out_features
    ratio = err_over_tol(out, plain, w4_tolerance(x, view, plain))
    golden_ratio = err_over_tol(out, golden, w4_tolerance(x, view, golden, golden=True))
    bitwise = bool(torch.equal(out, again))
    e = {"rows": R, "in": in_dim, "out": n, "group": w.group, "packing": w.packing,
         "x": str(x.dtype), "layer": layer,
         "splits": w4.split_k(R, in_dim // 2, n,
                              w4.tensor_core_route(x, w.group, w.packing))[1],
         "max_abs_err": (out.float() - plain.float()).abs().max().item(),
         "err_over_tol": ratio, "golden_err_over_tol": golden_ratio,
         "bitwise_repeat": bitwise, "ok": ratio <= 1.0 and golden_ratio <= 1.0 and bitwise}
    if timed:
        kernel, args, _, _operands = w4._w4_matmul_launch(x, view.packed, view.scale, **kw)
        e["ms"] = cuda_ms(lambda: kernel(*args), iters=50)
        # The whole wrapper (checks, allocations, ctypes call) on the host
        # clock, 50 calls and one sync: where it exceeds ms, the decode
        # step's host loop, not the kernel, sets this matmul's pace.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            w4.w4_matmul(x, w.packed, w.scale, layer=layer, **kw)
        torch.cuda.synchronize()
        e["wrapper_ms"] = (time.perf_counter() - t0) * 1e3 / 50
        e["plain_ms"] = cuda_ms(lambda: w4._w4_matmul_plain(x, view.packed, view.scale, **kw),
                                iters=3, warmup=1)
        e["nbytes"] = (view.packed.numel() + view.scale.numel() * 4
                       + (R * in_dim + R * n) * x.element_size())
        e["ops"] = {"bf16" if x.dtype == torch.bfloat16 else "fp32": 2 * R * in_dim * n}
        e["bound_ms"], e["bound_by"] = bound(e["nbytes"], e["ops"])
        e["library_ms"], e["library_rel_rms_err"], e["library_note"] = \
            _int4pack_library(x, view, golden)
    return e


def _w4_kernels(g):
    """The w4_matmul entry of the kernels line. Its ms, plain_ms, bound_ms
    and library_ms are sums over the four fused matmuls of one layer at
    R = 8 (a decode step runs them once per layer); `shapes` holds each
    matmul at R = 8, 1 and 32, `coverage` the cases off the main path."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import quantize_weight4
    shapes = []
    for name, in_dim, n in W4_MAIN:
        w = quantize_weight4(torch.randn((in_dim, n), generator=g, device="cuda") * in_dim**-0.5,
                             group=128, packing="halves")
        for R in W4_BATCHES:
            x = torch.randn((R, in_dim), generator=g, device="cuda").to(torch.bfloat16)
            shapes.append({"matmul": name, **_w4_case(x, w, timed=True)})
        del w
    coverage = []
    for R, in_dim, n, group, packing, f32, layer in W4_COVERAGE:
        shape = (in_dim, n) if layer is None else (3, in_dim, n)
        w = quantize_weight4(torch.randn(shape, generator=g, device="cuda"), group=group,
                             packing=packing)
        x = torch.randn((R, in_dim), generator=g, device="cuda")
        coverage.append(_w4_case(x if f32 else x.to(torch.bfloat16), w, layer, timed=False))
    main = [e for e in shapes if e["rows"] == W4_BATCHES[0]]
    ops = {}
    for e in main:
        for k, v in e["ops"].items():
            ops[k] = ops.get(k, 0) + v
    bms, by = bound(sum(e["nbytes"] for e in main), ops)
    lib = [e["library_ms"] for e in main]
    return {"name": "w4_matmul", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "quantizedmha_tpu/ops/w4_matmul.py:62",
            "also_replaces": "quantizedmha_tpu/ops/w4_matmul.py:46", "launches": None,
            "max_abs_err": max(e["max_abs_err"] for e in main),
            "err_over_tol": max(e["err_over_tol"] for e in shapes + coverage),
            "ok": all(e["ok"] for e in shapes + coverage),
            "ms": sum(e["ms"] for e in main), "plain_ms": sum(e["plain_ms"] for e in main),
            "bound_ms": bms, "bound_by": by,
            "library_ms": None if None in lib else sum(lib),
            "library_note": next((e["library_note"] for e in main if e["library_note"]), None),
            "shapes": shapes, "coverage": coverage}


# --- The FlashAttention backward: rows 6 and 7 ------------------------------


def flash_bwd_tolerances(q, k, v, o, lse, do, dlse, offsets, grads, *, sm_scale, causal,
                         window, softcap, sinks, exact_dots=False):
    """Per-element tolerances (dq, dk, dv) of the two backward kernels
    against _flash_bwd_plain on the same inputs (o, lse, di and dlse equal
    on both sides: the wrapper's di prepass is the plain version's op).

    Both compute in f32 from the same values and differ in summation order
    (u = 2^-24): a raw dot Q·K or dO·V of D exact products by at most
    2(D+16) u |q||k|max (two orders, Cauchy-Schwarz), so s moves by e_s =
    (2D+33) u |q||k|max sm_scale (with its rounding), plus 2^-22 cap under
    softcap (tanh ulps). p = exp(s - lse) moves by p·delta, delta = 1.01 e_s
    + 2^-22 (1 + |lse|) + 2^-21 (exp ulps, the subtraction); dp by e_dp =
    2(D+16) u |dO||v|max. ds = p (dp - di) sm_scale (1 - th²) moves by A =
    p (a |dp - di| + sm_scale e_dp), a = sm_scale (delta + 2 e_s / cap under
    softcap + 4u). A gradient sums N terms: dQ = dS·K over Skv keys, dK =
    dSᵀQ and dV = PᵀdO over the group's G·Sq rows; it moves by the sum of
    the terms' errors times the other factor, plus 2(N+1) u of the sum of
    the terms' magnitudes (two summation orders). A bf16 gradient adds one
    bf16 ulp, 2^-7 (|g| + tol).

    bf16 inputs: both sides round p and ds to bf16 (round to nearest even)
    as the operands of dV = PᵀdO, dK = dSᵀQ and dQ = dS·K (the TPU's
    Precision.DEFAULT). Each side rounds its own f32 p and ds, which differ
    by the errors above, so two values that sit on either side of a
    rounding boundary round one bf16 ulp apart (at most 2^-7 of the
    magnitude, 8 significant bits) on top of that difference: a term's
    error grows by 2^-7 |p| (in dV) and 2^-7 |ds| (in dK and dQ), carried
    through the three sums as A is (times |dO|, |q| and |k|). Rounding
    never moves a value by more than half an ulp, so the magnitudes in the
    summation-order terms grow by at most 2^-8, far inside that term.

    exact_dots: q, k, v and dO lie on a grid on which every product and
    partial sum of the raw dots Q·K and dO·V is exact in f32 (small
    multiples of a power of two), so both sides compute them exactly in any
    order: e_s keeps one rounding of s·sm_scale, u |q||k|max sm_scale (and
    tanh's ulps), and e_dp is u |dO||v|max. These cases let the f32 gate see
    a loss of precision after the dots (P or dS rounded to bf16) that the
    2(D+16) u bound of two summation orders would hide at d=256."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    u = 2.0**-24
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    di = fa._bwd_di(o, do, dlse)
    q_pos, k_pos = fa._bwd_positions(offsets, Sq, Skv)
    tols = [torch.zeros(x.shape, dtype=torch.float64, device=x.device) for x in grads]
    for h in range(Hkv):
        grp = slice(h * G, (h + 1) * G)
        qh, doh = q[:, grp].float(), do[:, grp].float()
        kh, vh = k[:, h].float(), v[:, h].float()
        p, dp, ds = fa._bwd_pairs(qh, kh, vh, doh, lse[:, grp], di[:, grp], q_pos, k_pos,
                                  sm_scale=sm_scale, causal=causal, window=window,
                                  softcap=softcap, sinks=sinks)
        kn = kh.norm(dim=-1).amax(dim=-1)[:, None, None]          # [B, 1, 1]
        vn = vh.norm(dim=-1).amax(dim=-1)[:, None, None]
        dot_u = u if exact_dots else 2 * (D + 16) * u
        e_s = (dot_u + u) * qh.norm(dim=-1) * kn * sm_scale         # [B, G, Sq]
        if softcap is not None:
            e_s = e_s + 2.0**-22 * softcap
        lse_h = torch.nan_to_num(lse[:, grp].float().abs(), posinf=0.0)
        delta = 1.01 * e_s + 2.0**-22 * (1.0 + lse_h) + 2.0**-21
        a = delta + 4 * u + (2.0 * e_s / softcap if softcap is not None else 0.0)
        e_dp = dot_u * doh.norm(dim=-1) * vn
        A = p * (sm_scale * a[..., None] * (dp - di[:, grp, :, None]).abs()
                 + sm_scale * e_dp[..., None])
        e_p = p * delta[..., None]
        if q.dtype == torch.bfloat16:
            A = A + 2.0**-7 * ds.abs()
            e_p = e_p + 2.0**-7 * p
        g_kv, g_q = 2 * (Skv + 1) * u, 2 * (G * Sq + 1) * u
        ka, qa, da = kh.abs()[:, None], qh.abs(), doh.abs()
        tols[0][:, grp] = (A @ ka + g_kv * (ds.abs() @ ka)).double()
        tols[1][:, h] = (torch.einsum("bgqk,bgqd->bkd", A, qa)
                         + g_q * torch.einsum("bgqk,bgqd->bkd", ds.abs(), qa)).double()
        tols[2][:, h] = (torch.einsum("bgqk,bgqd->bkd", e_p, da)
                         + g_q * torch.einsum("bgqk,bgqd->bkd", p, da)).double()
        del p, dp, ds, A, e_p
    if q.dtype == torch.bfloat16:
        tols = [t + 2.0**-7 * (g.double().abs() + t) for t, g in zip(tols, grads)]
    return tols


def _flash_bwd_check(q, k, v, offsets, do, dlse=None, *, causal, window=None, sinks=0,
                     softcap=None, exact_dots=False):
    """The float flash forward on the card (its o and lse, held to its plain
    version under flash_fwd_tolerances: the residuals the backward runs
    on), then the two backward launches against _flash_bwd_plain
    (flash_bwd_tolerances, with exact_dots for inputs on its grid): (kernel
    grads, plain grads, [dq, dk, dv] err_over_tol, [launch of dK/dV, of dQ],
    plain call, lse, whether a second pair of launches gave the same bits,
    the forward's [o, lse] err_over_tol)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, causal=causal, window=window, softcap=softcap, sinks=sinks)
    bkv = min(1024, k.shape[2])
    o, lse = fa._flash_fwd_cuda(q, k, v, offsets, block_kv=bkv, save_residuals=True, **kw)
    p_o, p_lse = fa._flash_fwd_plain(q, k, v, offsets, block_kv=bkv, save_residuals=True, **kw)
    w_abs = fa._flash_fwd_plain(q, k, v.abs(), offsets, block_kv=bkv, save_residuals=False, **kw)
    tol_o, tol_lse = flash_fwd_tolerances(q, k, v, p_o, p_lse, w_abs, sm_scale=sm,
                                          softcap=softcap)
    fwd = [err_over_tol(o, p_o, tol_o), err_over_tol(lse, p_lse, tol_lse)]
    del p_o, p_lse, w_abs, tol_o, tol_lse
    launches, grads, operands = fa._flash_bwd_launch(q, k, v, o, lse, do, offsets, dlse, **kw)
    for kernel, args in launches:
        kernel(*args)
    torch.cuda.synchronize()
    same_bits = _same_bits_again(lambda: [kernel(*args) for kernel, args in launches], grads)
    # Each launch closure holds the operands (the di prepass among them),
    # whose memory its raw pointers name.
    launches = [lambda kernel=kernel, args=args, keep=operands: kernel(*args)
                for kernel, args in launches]
    plain = fa._flash_bwd_plain(q, k, v, o, lse, do, offsets, dlse, **kw)
    tols = flash_bwd_tolerances(q, k, v, o, lse, do, dlse, offsets, plain, exact_dots=exact_dots,
                                **kw)
    ratios = [err_over_tol(g, p, t) for g, p, t in zip(grads, plain, tols)]
    return (grads, plain, ratios, launches,
            lambda: fa._flash_bwd_plain(q, k, v, o, lse, do, offsets, dlse, **kw), lse, same_bits,
            fwd)


def _sdpa_bwd(q, k, v, do, *, is_causal, attn_mask=None, dtype=None):
    """(ms, backend) of SDPA's backward in bf16 (or `dtype`: in f32 only the
    memory-efficient backend takes it, TF32 off) on these inputs, K/V
    expanded to the q heads beforehand (untimed): the time of
    torch.autograd.grad through one call minus the time of the call alone,
    the first of the flash, memory-efficient and cuDNN backends that takes
    them (with attn_mask, a [Sq, Skv] bool mask, in place of is_causal).
    One call computes dQ, dK and dV. The port never calls it."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = dtype or torch.bfloat16
    group = q.shape[1] // k.shape[1]
    qb, kb, vb = (x.to(dtype).repeat_interleave(r, dim=1).detach().requires_grad_()
                  for x, r in ((q, 1), (k, group), (v, group)))
    dob = do.to(dtype)

    def fwd():
        if attn_mask is not None:
            return sdpa(qb, kb, vb, attn_mask=attn_mask)
        return sdpa(qb, kb, vb, is_causal=is_causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qb, kb, vb), dob)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(backend):
                fwd_bwd()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            both = cuda_ms(fwd_bwd, iters=10)
            alone = cuda_ms(fwd, iters=10)
        return both - alone, backend.name
    return None, None


# The training step's attention: Llama-3-8B heads, 2048 tokens, bf16, causal.
BWD_MAIN = dict(B=1, H=32, Hkv=8, S=2048, D=128)


def _flash_bwd_cases(g):
    """Rows 6 and 7 at the training step's shape with a seeded random dO:
    check, kernel / plain / SDPA-backward times, each kernel's bound."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    B, H, Hkv, S, D = (BWD_MAIN[x] for x in ("B", "H", "Hkv", "S", "D"))
    bf = torch.bfloat16
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(bf)
    k, v = torch.randn((2, B, Hkv, S, D), generator=g, device="cuda").to(bf)
    do = torch.randn((B, H, S, D), generator=g, device="cuda").to(bf)
    grads, plain, ratios, launches, plain_call, _, same_bits, fwd = _flash_bwd_check(
        q, k, v, _offsets(0, 0, B, q.device), do, causal=True)
    plain_ms = cuda_ms(plain_call, iters=1, warmup=1)
    lib_ms, backend = _sdpa_bwd(q, k, v, do, is_causal=True)
    pairs = B * H * _visible_pairs(S, S, True)
    rows = 2 * B * H * S * D * 2                        # q and dO, bf16
    kv = 2 * B * Hkv * S * D * 2                        # k and v (dK, dV the same)
    stats = 2 * B * H * S * 4                           # lse and di, f32
    shape = dict(BWD_MAIN, causal=True, dtype="bfloat16")
    entries = []
    for (name, replaces, ops, nbytes, idx), launch in zip((
            ("flash_bwd_dkv", "quantizedmha_tpu/ops/flash_attention.py:507",
             {"bf16": 8 * pairs * D, "exp": pairs}, rows + kv + stats + kv, (1, 2)),
            ("flash_bwd_dq", "quantizedmha_tpu/ops/flash_attention.py:600",
             {"bf16": 6 * pairs * D, "exp": pairs},
             rows + kv + stats + B * H * S * D * 2, (0,))), launches):
        ms = cuda_ms(launch, iters=5)
        bms, by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": "quantizedmha_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max((grads[i].float() - plain[i].float()).abs().max().item()
                               for i in idx),
            "err_over_tol": max(ratios[i] for i in idx), "same_bits_twice": same_bits,
            "forward_err_over_tol": fwd,
            "ok": max([ratios[i] for i in idx] + fwd) <= 1.0 and same_bits,
            "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend,
            "library_note": ("SDPA backward in bf16 (K/V expanded to the q heads): one call "
                             "computes dQ, dK and dV; plain_ms is _flash_bwd_plain, both "
                             "kernels' work")})
    _train_f32_bwd(entries)
    return entries


def _bwd_subs(check, q, k, *, dlse, shape, pairs, lib):
    """Rows 6 and 7's sub-entries of one _flash_bwd_check on inputs q, k
    (with a dlse cotangent or not): {kernel name: sub-entry} with its check
    (the same bits twice; the forward behind it, row 5 with lse, held to its
    plain version, "forward_err_over_tol"), kernel / plain / library times
    (lib: (ms, backend)) and the bound over `pairs` visible pairs: one bf16
    pass of the four (dK/dV) or three (dQ) products on the tensor cores; in
    f32 six, beside their true f32 FMAs on the CUDA cores (_f32_bounds)."""
    import torch
    grads, plain, ratios, launches, plain_call, _, same_bits, fwd = check
    D, es = q.shape[-1], q.element_size()
    passes = 6 if q.dtype == torch.float32 else 1  # bf16 passes a product
    rows = 2 * q.numel() * es                        # q and dO
    kv = 2 * k.numel() * es                          # k and v (dK, dV the same)
    stats = (3 if dlse else 2) * (q.numel() // D) * 4  # lse, di (and dlse), f32
    out = {}
    for name, idx, products, nbytes, launch in (
            ("flash_bwd_dkv", (1, 2), 4, rows + kv + stats + kv, launches[0]),
            ("flash_bwd_dq", (0,), 3, rows + kv + stats + q.numel() * es, launches[1])):
        r = [ratios[i] for i in idx] + ([] if same_bits else [float("inf")])
        sub = _gemma2_sub(
            torch.stack([grads[i] for i in idx]), torch.stack([plain[i] for i in idx]), r,
            launch, plain_call, shape=shape, nbytes=nbytes,
            ops={"bf16": passes * 2 * products * pairs * D, "exp": pairs}, library=lambda: lib)
        sub["forward_err_over_tol"] = fwd
        sub["ok"] = sub["ok"] and max(fwd) <= 1.0
        if passes == 6:
            _f32_bounds(sub, nbytes, passes, pairs, D, products=products)
        out[name] = sub
    return out


def _train_f32_bwd(entries):
    """The f32 route of rows 6 and 7 at d <= 128 (no main path: train runs
    bf16) at BWD_MAIN's shape, causal, from its own generator: each entry's
    "train_f32" sub-entry (_bwd_subs, SDPA's f32 backward)."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    B, H, Hkv, S, D = (BWD_MAIN[x] for x in ("B", "H", "Hkv", "S", "D"))
    g = torch.Generator(device="cuda").manual_seed(17)
    q = torch.randn((B, H, S, D), generator=g, device="cuda")
    k, v = torch.randn((2, B, Hkv, S, D), generator=g, device="cuda")
    do = torch.randn((B, H, S, D), generator=g, device="cuda")
    check = _flash_bwd_check(q, k, v, _offsets(0, 0, B, q.device), do, causal=True)
    lib = _sdpa_bwd(q, k, v, do, is_causal=True, dtype=torch.float32)
    subs = _bwd_subs(check, q, k, dlse=False, shape=dict(BWD_MAIN, causal=True, dtype="float32"),
                     pairs=B * H * _visible_pairs(S, S, True), lib=lib)
    for e in entries:
        e["train_f32"] = subs[e["name"]]
        e["ok"] = e["ok"] and e["train_f32"]["ok"]


def _gemma2_bwd(g):
    """Rows 6 and 7 at d=256, train_gemma2's and train_gemma2_f32's
    attention (GEMMA2_ATTN: 16 q over 8 kv heads, sm_scale 256^-0.5,
    softcap 50) at Gemma-2's 8192 tokens with a seeded random dO and a dlse
    cotangent: "full" (causal) and "sliding" (the 4096 window) in bf16,
    "full_f32" and "sliding_f32" in f32, each through _bwd_subs: launched
    twice (the same bits), held to _flash_bwd_plain within
    flash_bwd_tolerances, the forward behind it (row 5 at train_gemma2's
    and train_gemma2_f32's shape, with lse) held to its plain version;
    SDPA's backward at the same shape and dtype (no softcap: it has none;
    the window in its mask; f32 on the memory-efficient backend) as the
    library time. {kernel name: {kind: sub-entry}}."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    ga = GEMMA2_ATTN
    Hq, Hkv, D, cap = ga["Hq"], ga["Hkv"], ga["D"], ga["softcap"]
    S = TRAIN_GEMMA2["tokens"]
    out = {"flash_bwd_dkv": {}, "flash_bwd_dq": {}}
    for dt, kind, window in ((torch.bfloat16, "full", None),
                             (torch.bfloat16, "sliding", ga["window"]),
                             (torch.float32, "full_f32", None),
                             (torch.float32, "sliding_f32", ga["window"])):
        q = torch.randn((1, Hq, S, D), generator=g, device="cuda").to(dt)
        k, v = torch.randn((2, 1, Hkv, S, D), generator=g, device="cuda").to(dt)
        do = torch.randn((1, Hq, S, D), generator=g, device="cuda").to(dt)
        dlse = torch.randn((1, Hq, S), generator=g, device="cuda")
        check = _flash_bwd_check(q, k, v, _offsets(0, 0, 1, q.device), do, dlse, causal=True,
                                 window=window, softcap=cap)
        mask = None
        if window is not None:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib = _sdpa_bwd(q, k, v, do, is_causal=True, attn_mask=mask, dtype=dt)
        shape = {"B": 1, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "causal": True,
                 "window": window, "softcap": cap, "dlse": True, "dtype": str(dt)[6:]}
        subs = _bwd_subs(check, q, k, dlse=True, shape=shape,
                         pairs=Hq * _int8p_window_pairs(S, window), lib=lib)
        for name, sub in subs.items():
            out[name][kind] = sub
        del q, k, v, do, dlse, check, subs, mask
        gc.collect()
        torch.cuda.empty_cache()
    return out


# Small cases off the training path, each kernel against plain on the card:
# f32, d 32/64, MQA, group 1, cross attention at unaligned lengths, a window
# smaller than a tile with and without sinks that end mid-tile, softcap,
# per-batch offsets with fully masked rows, a non-zero dlse.
#   (B, H, Hkv, Sq, Skv, D, causal, window, sinks, softcap, bf16,
#    per-batch (q_off, kv_off) or None for end-aligned, dlse)
FLASH_BWD_COVERAGE = (
    (2, 4, 2, 100, 190, 32, False, None, 0, None, False, None, False),
    (1, 4, 1, 130, 130, 64, True, None, 0, None, True, None, False),
    (1, 4, 4, 96, 96, 128, True, None, 0, None, False, None, False),
    (1, 2, 2, 200, 392, 64, False, None, 0, None, True, None, False),
    (1, 4, 2, 150, 150, 64, True, 40, 0, None, True, None, False),
    (1, 4, 2, 150, 200, 64, True, 40, 37, None, True, None, False),
    (1, 8, 2, 77, 77, 32, True, None, 0, 20.0, True, None, False),
    (1, 4, 2, 64, 96, 32, True, 24, 5, 10.0, False, None, False),
    (2, 4, 2, 64, 100, 64, True, None, 0, None, False, ((30, 0), (0, 20)), False),
    (1, 4, 2, 90, 90, 128, True, None, 0, None, True, None, True),
    (1, 2, 1, 70, 120, 32, True, 16, 0, None, False, ((10, 40),), True),
    # d=256 (Gemma-2's training path), in bf16 and then in f32: GQA 2:1 with
    # softcap 50 at a length that is no multiple of 64; 1:1 cross attention,
    # not causal; Sq != Skv at explicit offsets per sequence with a dlse,
    # whose first sequence's 40 rows see no key (dq exactly 0); a window
    # with sinks that end mid-tile, softcap and a dlse; a window that skips
    # whole tiles.
    *(case for bf16 in (True, False) for case in (
        (1, 4, 2, 150, 150, 256, True, None, 0, 50.0, bf16, None, False),
        (2, 2, 2, 100, 190, 256, False, None, 0, None, bf16, None, False),
        (2, 4, 2, 70, 130, 256, True, None, 0, None, bf16, ((0, 40), (60, 0)), True),
        (1, 4, 2, 200, 260, 256, True, 48, 5, 50.0, bf16, None, True),
        (1, 4, 2, 400, 400, 256, True, 100, 0, 50.0, bf16, None, False))),
)


# f32 at d=256 on a grid (multiples of 1/4 in [-3/4, 3/4]: every product
# and partial sum of Q·K and dO·V is exact in f32), held with exact_dots:
# a dS rounded to bf16 fails these by ~100x where the summation-order bound
# of the random cases leaves it at 2-3x, too little for the faults phase's
# 10x rule. GQA 2:1, 4 over 2 heads at 48 tokens under a window of 30 and 8
# over 4 heads at 40 tokens, causal, softcap 50, a dlse.
#   (B, H, Hkv, Sq, Skv, window)
FLASH_BWD_GRID = ((1, 4, 2, 48, 48, 30), (1, 8, 4, 40, 40, None))


def flash_bwd_grid_inputs(g, case, device="cuda"):
    """(q, k, v, dO, dlse, offsets) of one FLASH_BWD_GRID case, f32."""
    import torch
    B, H, Hkv, Sq, Skv, _ = case
    def grid(*shape):
        return torch.randint(-3, 4, shape, generator=g, device=device).float() * 0.25
    q, do = grid(B, H, Sq, 256), grid(B, H, Sq, 256)
    k, v = grid(B, Hkv, Skv, 256), grid(B, Hkv, Skv, 256)
    dlse = torch.randn((B, H, Sq), generator=g, device=device)
    offsets = torch.tensor([[Skv - Sq, 0]] * B, dtype=torch.int32, device=device)
    return q, k, v, do, dlse, offsets


def flash_bwd_coverage_inputs(g, case, device="cuda"):
    """(q, k, v, dO, dlse or None, offsets, masks) of one FLASH_BWD_COVERAGE
    case."""
    import torch
    B, H, Hkv, Sq, Skv, D, causal, window, sinks, cap, bf16, offs, with_dlse = case
    dt = torch.bfloat16 if bf16 else torch.float32
    q = (torch.randn((B, H, Sq, D), generator=g, device=device) * 1.5).to(dt)
    k, v = torch.randn((2, B, Hkv, Skv, D), generator=g, device=device).to(dt)
    do = torch.randn((B, H, Sq, D), generator=g, device=device).to(dt)
    dlse = torch.randn((B, H, Sq), generator=g, device=device) if with_dlse else None
    offsets = torch.tensor([[Skv - Sq, 0]] * B if offs is None else offs, dtype=torch.int32,
                           device=device)
    return q, k, v, do, dlse, offsets, dict(causal=causal, window=window, sinks=sinks,
                                            softcap=cap)


def _coverage_bwd(g):
    """FLASH_BWD_COVERAGE and FLASH_BWD_GRID: {case: [dq, dk, dv, the
    forward's o, lse] err_over_tol}; a row whose lse is -inf (it sees no
    key) must get dq exactly 0, and a second pair of launches must give the
    same bits (inf appended otherwise)."""
    import torch
    ratios = {}
    for i, case in enumerate(FLASH_BWD_COVERAGE):
        q, k, v, do, dlse, offsets, masks = flash_bwd_coverage_inputs(g, case)
        grads, _, r, _, _, lse, same_bits, fwd = _flash_bwd_check(q, k, v, offsets, do, dlse,
                                                                  **masks)
        r = r + fwd
        empty = torch.isinf(lse)
        if empty.any() and not bool((grads[0][empty] == 0).all()):
            r = r + [float("inf")]
        if not same_bits:
            r = r + [float("inf")]
        ratios[f"flash_bwd{i}"] = r
    for i, case in enumerate(FLASH_BWD_GRID):
        q, k, v, do, dlse, offsets = flash_bwd_grid_inputs(g, case)
        _, _, r, _, _, _, same_bits, fwd = _flash_bwd_check(
            q, k, v, offsets, do, dlse, causal=True, window=case[-1], softcap=50.0,
            exact_dots=True)
        ratios[f"flash_bwd_grid{i}"] = r + fwd + ([] if same_bits else [float("inf")])
    return ratios


def phase_kernels(st):
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    # Prefill attention of the serve path: Llama-3-8B heads, a 256 bucket,
    # bf16 activations, block_kv = min(1024, 256) (pick_blocks).
    qp = torch.randn((1, 32, 256, 128), generator=g, device="cuda").to(torch.bfloat16)
    kp = torch.randn((1, 8, 256, 128), generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn((1, 8, 256, 128), generator=g, device="cuda").to(torch.bfloat16)
    # The solve path: N=8192, 32 heads of d=32, float32, block_kv 512.
    qs = torch.randn((1, 32, 8192, 32), generator=g, device="cuda")
    ks = torch.randn((1, 32, 8192, 32), generator=g, device="cuda")
    vs = torch.randn((1, 32, 8192, 32), generator=g, device="cuda")
    int8_p = _flash_case("flash_int8_fwd[int8_p]", 0, qp, kp, vp, 256, True,
                         replaces="quantizedmha_tpu/ops/flash_attention_int8.py:80",
                         library=True)
    # serve_w4's prefill (most of the kernel's launches): 512-token prompts,
    # one a launch, block_kv = min(1024, 512); drawn from its own generator,
    # so that every other kernel keeps its inputs.
    g4 = torch.Generator(device="cuda").manual_seed(13)
    q4 = torch.randn((1, 32, 512, 128), generator=g4, device="cuda").to(torch.bfloat16)
    k4, v4 = torch.randn((2, 1, 8, 512, 128), generator=g4, device="cuda").to(torch.bfloat16)
    w4_prefill = _flash_case("flash_int8_fwd[int8_p]", 0, q4, k4, v4, 512, True,
                             replaces="quantizedmha_tpu/ops/flash_attention_int8.py:80",
                             library=True)
    del q4, k4, v4
    # The prefill bench's attention: 2048 tokens, block_kv as prefill_at
    # picks it (pick_blocks: min(1024, 2048)); its own generator too.
    g2 = torch.Generator(device="cuda").manual_seed(15)
    q2 = torch.randn((1, 32, PREFILL_BENCH_LEN, 128), generator=g2,
                     device="cuda").to(torch.bfloat16)
    k2, v2 = torch.randn((2, 1, 8, PREFILL_BENCH_LEN, 128), generator=g2,
                         device="cuda").to(torch.bfloat16)
    bench_prefill = _flash_case("flash_int8_fwd[int8_p]", 0, q2, k2, v2,
                                fa.pick_blocks(PREFILL_BENCH_LEN, PREFILL_BENCH_LEN, 128)[1],
                                True, replaces="quantizedmha_tpu/ops/flash_attention_int8.py:80",
                                library=True)
    del q2, k2, v2
    sub_keys = ("max_abs_err", "err_over_tol", "same_bits_twice", "ok", "shape", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
    int8_p["serve_w4"] = {k: w4_prefill[k] for k in sub_keys}
    int8_p["prefill_bench"] = {k: bench_prefill[k] for k in sub_keys}
    int8_p["ok"] = int8_p["ok"] and w4_prefill["ok"] and bench_prefill["ok"]
    # The bf16-P modes at solve's shape: mode 1 (solve's fa_int8) and mode 2
    # (int8_modes' flash_attention_int8_t(summode="vpu") twin), which also
    # stands for the standard kernel's pv_dtype="bf16".
    bf16_p_f32l = _flash_case("flash_int8_fwd[bf16_p_f32l]", 2, qs, ks, vs, 512, False,
                              replaces="quantizedmha_tpu/ops/flash_attention_int8.py:437",
                              library=True)
    bf16_p_f32l["also_replaces"] = "quantizedmha_tpu/ops/flash_attention_int8.py:80"
    cases = [
        int8_p,
        _flash_case("flash_int8_fwd[bf16_p]", 1, qs, ks, vs, 512, False,
                    replaces="quantizedmha_tpu/ops/flash_attention_int8.py:437",
                    library=True),
        bf16_p_f32l,
    ]
    # DECODE_MAIN: serve's shape is the entry; the same CUDA kernel stands
    # for the per-kv-head grid form used for MQA (serve_tp's tp=8 ranks give
    # it Hkv=1) and runs serve_flash's deep decode: both checked and timed
    # here and reported inside the paged_decode entry.
    serve, mqa, deep = (
        _decode_case("paged_decode", hkv, seed=seed, lengths=lens, max_pages=slots,
                     replaces="quantizedmha_tpu/ops/decode.py:" + ("53" if hkv == 1 else "527"))
        for hkv, seed, lens, slots in DECODE_MAIN.values())
    cases.append(serve)
    keys = ("replaces", "max_abs_err", "err_over_tol", "ok", "same_bits_twice", "shape", "ms",
            "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend")
    cases[-1]["also_replaces"] = mqa["replaces"]
    cases[-1]["mqa"] = {k: mqa[k] for k in keys}
    cases[-1]["serve_flash"] = {k: deep[k] for k in keys}
    cases[-1]["ok"] = cases[-1]["ok"] and mqa["ok"] and deep["ok"]
    cases.append(_w4_kernels(g))
    # The float flash kernel: the serve_flash bucketed prefill (bf16, a
    # 2048 bucket, Llama-3-8B heads, causal) and solve's fa / fa_bf16 rungs
    # (N=8192, 32 heads of d=32, not causal), the bf16 one reported inside
    # the bf16 entry.
    qf = torch.randn((1, 32, 2048, 128), generator=g, device="cuda").to(torch.bfloat16)
    kf, vf = torch.randn((2, 1, 8, 2048, 128), generator=g, device="cuda").to(torch.bfloat16)
    fwd = _flash_fwd_case("flash_fwd[bf16]", qf, kf, vf, True, label="serve_flash prefill",
                          replaces="quantizedmha_tpu/ops/flash_attention.py:124")
    del qf, kf, vf
    solve_bf16 = _flash_fwd_case("flash_fwd[bf16]", *(x.to(torch.bfloat16) for x in (qs, ks, vs)),
                                 False, label="solve fa_bf16",
                                 replaces="quantizedmha_tpu/ops/flash_attention.py:124")
    fwd["solve"] = {k: solve_bf16[k] for k in ("max_abs_err", "err_over_tol", "same_bits_twice",
                                               "ok", "shape", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "library_backend")}
    fwd["ok"] = fwd["ok"] and solve_bf16["ok"]
    cases.append(fwd)
    cases.append(_flash_fwd_case("flash_fwd[f32]", qs, ks, vs, False, label="solve fa",
                                 replaces="quantizedmha_tpu/ops/flash_attention.py:124"))
    cases.append(_paged_prefill_case(g, replaces="quantizedmha_tpu/ops/paged_prefill.py:63"))
    # Row 10 at serve_tp's verify shape (d=128, 8 q / 2 kv heads a rank).
    cases[-1]["verify_tp"] = verify_sub(torch.Generator(device="cuda").manual_seed(390),
                                        VERIFY_TP["case"], VERIFY_TP["slots"])
    cases[-1]["ok"] = cases[-1]["ok"] and cases[-1]["verify_tp"]["ok"]
    # The INT4 kernels of the mixed cache at serve_mixed's shapes.
    cases.append(_int4_prefill_case(g))
    cases.append(_int4_decode_case(g))
    # The training step's backward: rows 6 (dK/dV) and 7 (dQ).
    cases += _flash_bwd_cases(g)
    # Rows 3, 5 and 10 at head_dim 256, serve_hybrid's Gemma-2 shapes; row
    # 1 at serve_hf's, rows 1-2's bf16-P modes at int8_modes'.
    by_name = {c["name"]: c for c in cases}
    for name, subs in _gemma2_kernels().items():
        by_name[name]["gemma2"] = subs
        by_name[name]["ok"] = by_name[name]["ok"] and all(x["ok"] for x in subs.values())
    st["kernels"] = by_name
    ok = all(c["ok"] for c in cases)
    emit({"phase": "kernels", "ok": ok, "kernels": cases})
    # Off the main paths second, so that a failing kernel reports its
    # main-path errors as well.
    coverage = _coverage()
    emit({"phase": "kernels_coverage", **coverage})
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version")
    if not coverage["ok"]:
        raise AssertionError("a kernel disagrees with its plain version off the main paths")


# One line of a kernel source changed: (file under csrc/, what the fault
# does, the line as committed, the line planted[, the sources built]). Each
# must fail the kernels phase's checks (main shapes and coverage cases,
# err_over_tol > 1) of every float kernel built from that file, or of the
# sources named where a header's line is compiled only into some of the
# sources that include it (mma_bf16.cuh's d=256 product: the d=256 kernels).
PLANTED_FAULTS = (
    ("flash_fwd.cu", "kv edge unmasked (keys past Skv kept)",
     "bool valid = kloc < p.Skv;", "bool valid = true;"),
    ("flash_fwd.cu", "bf16 P·V: each k16 step of P against the V rows of the neighbouring step",
     "for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], tile_desc_mn(vt, 16 * kk));",
     "for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], tile_desc_mn(vt, 16 * (kk ^ 1)));"),
    ("flash_fwd.cu", "bf16: P's two keys swapped when packed to the A fragment",
     "const __nv_bfloat162 pb = __floats2bfloat162_rn(sc[nt][2 * r], sc[nt][2 * r + 1]);",
     "const __nv_bfloat162 pb = __floats2bfloat162_rn(sc[nt][2 * r + 1], sc[nt][2 * r]);"),
    ("flash_fwd.cu", "bf16: next key tile copied into the stage being read",
     "issue(t0, s);", "issue(t0, (n + 1) % R::STAGES);"),
    ("flash_fwd.cu", "bf16: acc not rescaled when a row's max moved",
     "if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {", "if (false) {"),
    ("flash_fwd.cu", "bf16: a folded row's Q taken from the group's next q head",
     "const int gi = hc * p.GB + br / p.NQ;  // the row's q head within the group",
     "const int gi = min(hc * p.GB + br / p.NQ + 1, p.G - 1);"),
    ("flash_fwd.cu", "bf16: a tile taken as wholly visible when the warp's last row sees it",
     "range_unmasked(p, wspan.x, wspan.y, k_first, kv_off + t0 + BKV - 1, t0 + BKV - 1);",
     "range_unmasked(p, wspan.y, wspan.y, k_first, kv_off + t0 + BKV - 1, t0 + BKV - 1);"),
    ("mma_bf16.cuh", "d=256: P·V's second column half against V's first (O's columns 128-255)",
     "wgmma_rs_m64n128(*reinterpret_cast<float(*)[16][4]>(&acc[16]), a, m + (2 * SW_ROWS * 64 * 2 >> 4), 1);",
     "wgmma_rs_m64n128(*reinterpret_cast<float(*)[16][4]>(&acc[16]), a, m, 1);",
     ("flash_fwd", "paged_prefill")),
    ("flash_fwd.cu", "f32: Q's third piece dropped (S without q2·k0)",
     "qk(2, 0);  // q2·k0: Q's third piece", ";"),
    ("flash_fwd.cu", "f32: K's third piece dropped (S without q0·k2)",
     "qk(0, 2);  // q0·k2: K's third piece", ";"),
    ("flash_fwd.cu", "f32: P's third piece dropped (P·V without p2·v0)",
     "pvp(2, 0);  // p2·v0: P's third piece", ";"),
    ("flash_fwd.cu", "f32: V's third piece dropped (P·V without p0·v2)",
     "pvp(0, 2);  // p0·v2: V's third piece", ";"),
    ("flash_fwd.cu", "f32: a1 taken as bf16(a) − a0, not the exact residual a − a0",
     "const float2 r1 = make_float2(x - __low2float(h0), y - __high2float(h0));",
     "const float2 r1 = make_float2(__low2float(h0) - __low2float(h0), "
     "__high2float(h0) - __high2float(h0));"),
    ("flash_fwd.cu", "f32: V's planes copied from K's",
     "cp_async16(st + R::plane(3 + j) + sw(r, c), vg + j * kv_plane + src, ok);",
     "cp_async16(st + R::plane(3 + j) + sw(r, c), kg + j * kv_plane + src, ok);"),
    ("flash_fwd.cu", "f32: next key tile copied into the stage being read",
     "copy_tile(t0, s);", "copy_tile(t0, (n + 1) % R::STAGES);"),
    ("flash_fwd.cu", "f32: acc not rescaled when a row's max moved",
     "if (__any_sync(0xffffffffu, (alpha[0] != 1.f) | (alpha[1] != 1.f))) {", "if (false) {"),
    ("flash_fwd.cu", "f32: a folded row's Q taken from the group's next q head",
     "const int head = hc * p.GB + br / p.NQ;  // the row's q head in the group",
     "const int head = min(hc * p.GB + br / p.NQ + 1, p.G - 1);"),
    ("flash_fwd.cu", "f32: a tile taken as wholly visible when the warp's last row sees it",
     "const bool unmasked = range_unmasked(p, span.x, span.y, k_first,",
     "const bool unmasked = range_unmasked(p, span.y, span.y, k_first,"),
    ("flash_fwd.cu", "f32: a tile's P·V never added to acc",
     "for (int e = 0; e < 4; ++e) acc[c][e] += pacc[c][e];", "for (int e = 0; e < 4; ++e) ;"),
    ("flash_fwd.cu", "f32 split pass: V's last 32 values (its last row at d=32) left unwritten",
     "const size_t chunks = (nq + 2 * nkv) / 8;", "const size_t chunks = (nq + 2 * nkv) / 8 - 4;"),
    ("f32_tile.cuh", "f32 tile: each thread's own tile max, not the row's",
     "const float m_next = fmaxf(m[i], row_max16(mt));", "const float m_next = fmaxf(m[i], mt);"),
    ("paged_prefill.cu", "diagonal masked (kpos < qpos; both routes)",
     "bool valid = kpos <= qpos && kpos < kend;", "bool valid = kpos < qpos && kpos < kend;"),
    ("paged_prefill.cu", "bf16: V scale of the next physical page",
     "cp_async4(sk + BK + gtid, p.vs + sidx, ok);", "cp_async4(sk + BK + gtid, p.vs + sidx + 1, ok);"),
    ("paged_prefill.cu", "window one key wider (kpos >= qpos - window; both routes)",
     "if (p.window >= 0) valid &= kpos > qpos - p.window || kpos < p.sinks;",
     "if (p.window >= 0) valid &= kpos >= qpos - p.window || kpos < p.sinks;"),
    ("paged_prefill.cu", "bf16: P's two keys swapped when packed to the A fragment",
     "__floats2bfloat162_rn(sc[n][2 * r] * vc[n][0], sc[n][2 * r + 1] * vc[n][1]));",
     "__floats2bfloat162_rn(sc[n][2 * r + 1] * vc[n][1], sc[n][2 * r] * vc[n][0]));"),
    ("paged_prefill.cu", "bf16: next key tile copied into the stage being converted",
     "if (tn < rows.kend) issue(tn, buf ^ 1);", "if (tn < rows.kend) issue(tn, buf);"),
    ("paged_prefill.cu", "bf16: K scales of the key pair two columns on",
     "const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * n + 2 * t);",
     "const float2 k2 = *reinterpret_cast<const float2*>(sk + ((8 * n + 2 * t + 2) & (BK - 1)));"),
    ("paged_prefill.cu", "bf16: a tile taken as wholly visible when the warp's last row sees it",
     "const bool unmasked = t0 + BK <= rows.kend && t0 + BK - 1 <= wq_lo &&",
     "const bool unmasked = t0 + BK <= rows.kend && t0 + BK - 1 <= wq_hi &&"),
    ("paged_prefill.cu", "d=256 (one raw stage a producer): its next copy fetches the tile after",
     "          issue(tn, 0);", "          issue(skip_one(tn), 0);"),
    ("int4.cuh", "high nibble shifted as unsigned (0..15, not -8..7)",
     "__device__ __forceinline__ int int4_hi(int b) { return b >> 4; }",
     "__device__ __forceinline__ int int4_hi(int b) { return (b & 0xff) >> 4; }"),
    ("paged_decode.cu", "INT4 sub-tile scale index off by one",
     "const int sub = t / sub_w;", "const int sub = (t / sub_w + 1) % p.subs;"),
    ("paged_prefill.cu", "negative q_start clamped to 0 (both routes)",
     "const int qstart = p.qstarts[b];", "const int qstart = max(p.qstarts[b], 0);"),
    ("paged_decode.cu", "empty row's lse 0, not -inf",
     "return l == 0.f ? -INFINITY : m + logf(fmaxf(l, 1e-38f));",
     "return l == 0.f ? 0.f : m + logf(fmaxf(l, 1e-38f));"),
    ("paged_decode.cu", "a split's page range one page too long (pages counted twice)",
     "const int p_end = min(p_begin + p.pages_per_split, n_pages);",
     "const int p_end = min(p_begin + p.pages_per_split + 1, n_pages);"),
    ("paged_decode.cu", "merge without a split's rescale",
     "const float w = expf(ms - mx);", "const float w = 1.f;"),
    ("paged_decode.cu", "an empty split's m taken as 0",
     "p.ml[mslot + g] = -INFINITY;", "p.ml[mslot + g] = 0.f;"),
    ("paged_decode.cu", "a split's sums written to the neighbouring split's slot",
     "p.part[((size_t(s) * p.B + b) * p.Hq + hq0) * D + e] = sum;",
     "p.part[((size_t((s + 1) % p.splits) * p.B + b) * p.Hq + hq0) * D + e] = sum;"),
    ("paged_decode.cu", "next page copied into the stage being read",
     "if (nxt < p_end) issue(nxt, buf ^ 1);", "if (nxt < p_end) issue(nxt, buf);"),
    ("paged_decode.cu", "scores' reduce-scatter: the two head pairs swapped",
     "hoff = up ? 2 : 0;", "hoff = up ? 0 : 2;"),
    ("paged_decode.cu", "INT4 high nibbles not re-biased (read as n + 8)",
     "hi[c] = __uint_as_float(__byte_perm(hb, 0x4B000000u, 0x7540 + c)) - 8388616.f;",
     "hi[c] = __uint_as_float(__byte_perm(hb, 0x4B000000u, 0x7540 + c)) - 8388608.f;"),
    ("paged_decode.cu", "d=256: the scores' fifth reduce-scatter step dropped",
     "if constexpr (LPR >= 16) dot[0] += __shfl_xor_sync(FULL, dot[0], LPR / 16);",
     "if constexpr (LPR >= 16) dot[0] += 0.f;"),
    ("paged_decode.cu", "d=256 int8: a V row's second 4-byte word of a lane read as its first",
     "int8x4(w.y, vf + 4);", "int8x4(w.x, vf + 4);"),
    ("paged_decode.cu", "window's first page skipped one page too far",
     "w0 = max(length - p.window, 0) / P;", "w0 = max(length - p.window, 0) / P + 1;"),
    ("flash_bwd.cu", "bf16 dK/dV: the group's last q head left out of the sum",
     "const bool more = hd_next < group;", "const bool more = hd_next < group - 1;"),
    ("flash_bwd.cu", "softcap's 1 - tanh² chain factor dropped",
     "if (capped) ds *= 1.f - th * th;", "if (capped) ds *= 1.f;"),
    ("flash_bwd.cu", "dlse folded with the wrong sign (di + dlse: f32, bf16 dQ)",
     "if (p.dlse != nullptr) d = d - p.dlse[at];", "if (p.dlse != nullptr) d = d + p.dlse[at];"),
    ("flash_bwd.cu", "bf16 dK/dV: dlse folded with the wrong sign",
     "const float dr = st_s[BR + r] - st_s[2 * BR + r];",
     "const float dr = st_s[BR + r] + st_s[2 * BR + r];"),
    ("flash_bwd.cu", "window one key wider (qpos - kpos <= window)",
     "bool in_win = (qpos - kpos) < p.window;", "bool in_win = (qpos - kpos) <= p.window;"),
    ("flash_bwd.cu", "bf16: P/dS packed into the A operand with its halves swapped",
     "__floats2bfloat162_rn(x[2 * kk + hh][2 * r], x[2 * kk + hh][2 * r + 1]);",
     "__floats2bfloat162_rn(x[2 * kk + hh][2 * r + 1], x[2 * kk + hh][2 * r]);"),
    ("flash_bwd.cu", "bf16 dK/dV: lse/di of the transposed tile's q row from the key half",
     "const int r = 32 * h + 8 * n + 2 * t + (e & 1);",
     "const int r = 32 * h + 8 * n + 2 * t + (e >> 1);"),
    ("flash_bwd.cu", "bf16 dK/dV: next Q/dO tile copied into the stage being read (stale reads)",
     "if (more) issue(hd_next, q_next, buf ^ 1);", "if (more) issue(hd_next, q_next, buf);"),
    ("flash_bwd.cu", "d=256 dK/dV: dV's second column half from dO's first (dV's columns 128-255)",
     "wgmma_ss_m64n128(acc_v, tile_desc(pts, 0, kk), tile_desc_mn(dot, 16 * kk) + half, 1);",
     "wgmma_ss_m64n128(acc_v, tile_desc(pts, 0, kk), tile_desc_mn(dot, 16 * kk), 1);"),
    ("flash_bwd.cu", "d=256 dK/dV: group 1's dSᵀ written over group 0's q rows (rows 32-63 of "
     "each q tile never reach dK)",
     "put_scores(dsts, 16 * warp, r0, dpt);", "put_scores(dsts, 16 * warp, 0, dpt);"),
    ("flash_bwd.cu", "d=256 dQ: group 1's K read from column block 1, not 2 (a descriptor base "
     "that misses the third swizzle block: dQ's columns 128-255)",
     "wgmma_ss_m64n128(acc, tile_desc(dss, 0, kk), tile_desc_mn(kt, 16 * kk) + half, 1);",
     "wgmma_ss_m64n128(acc, tile_desc(dss, 0, kk), tile_desc_mn(kt, 16 * kk) + half / 2, 1);"),
    ("flash_bwd.cu", "d=256 dK/dV: dlse folded with the wrong sign",
     "st_s[BR + r] - st_s[2 * BR + r]);  // di − dlse",
     "st_s[BR + r] + st_s[2 * BR + r]);  // di − dlse"),
    ("flash_bwd.cu", "f32 dQ: dS rounded to bf16 before dQ += dS·K",
     "const float ds = score_grad<CAP>(p, valid, s[i][j], dp[i][j], lse_s[r], di_s[r]).y;",
     "const float ds = __bfloat162float(__float2bfloat16("
     "score_grad<CAP>(p, valid, s[i][j], dp[i][j], lse_s[r], di_s[r]).y));"),
    ("flash_bwd.cu", "f32 dK/dV: dSᵀ rounded to bf16 before dK += dSᵀ·Q",
     "for (int j = 0; j < 4; ++j) pds[(ty * 4 + i) * T::PROW + tx + 16 * j] = dpt[i][j];",
     "for (int j = 0; j < 4; ++j) pds[(ty * 4 + i) * T::PROW + tx + 16 * j] = "
     "__bfloat162float(__float2bfloat16(dpt[i][j]));"),
    ("flash_bwd.cu", "f32 dQ: K lands in V's tile before dP = dO·Vᵀ is done (dP from K)",
     "dot_tile<D>(dos, kvt, dp);  // dP = dO·Vᵀ",
     "land<D>(kvt, kg, t0, p.Skv); dot_tile<D>(dos, kvt, dp);"),
    ("flash_bwd.cu", "f32 dK/dV: the group's last q head left out of the sum",
     "for (int hd = 0; hd < group; ++hd) {  // the group's q heads, in order",
     "for (int hd = 0; hd < group - 1; ++hd) {"),
    ("w4_matmul.cu", "bf16: the high plane's scales from the next group (the last one's own)",
     "const size_t src = ok ? size_t(g0 + slot + plane * hi_goff) * p.n + col : 0;",
     "const size_t src = ok ? size_t(min(g0 + slot + plane * (hi_goff + 1), "
     "in_dim / p.group - 1)) * p.n + col : 0;"),
    ("w4_matmul.cu", "bf16: the low plane's +8 storage bias left in",
     "return __uint_as_float(bits) - float((1 << (23 - O)) + 8);",
     "return __uint_as_float(bits) - float((1 << (23 - O)) + (HI ? 8 : 0));"),
    ("w4_matmul.cu", "split-K: the second split's partial sums dropped (both routes)",
     "for (int s = 1; s < splits; ++s) v += ws[size_t(s) * total + e];",
     "for (int s = 1; s < splits; ++s) v += s == 1 ? 0.f : ws[size_t(s) * total + e];"),
    ("w4_matmul.cu", "bf16: A fragment's k pair swapped (packed rows 2t and 2t+1)",
     "a[0][0] = weight_pair<HI, 0>(w0, v0, w1, v1, s.x, mk);",
     "a[0][0] = weight_pair<HI, 0>(w1, v1, w0, v0, s.x, mk);"),
    ("w4_matmul.cu", "bf16: the low plane's nibbles read as two's complement",
     "constexpr uint32_t MAGIC = (uint32_t(150 - O) << 23) | (HI ? 8u << O : 0u);",
     "constexpr uint32_t MAGIC = (uint32_t(150 - O) << 23) | (8u << O);"),
    ("w4_matmul.cu", "bf16: the next stage's packed tile read (not yet landed)",
     "const unsigned char* pt = packed_tile(s) + 2 * t * PROW + colw;",
     "const unsigned char* pt = packed_tile((n + 1) % R::STAGES) + 2 * t * PROW + colw;"),
    ("w4_matmul.cu", "bf16: output columns permuted (tile 0's row g + 8 and tile 1's row g swapped)",
     "const float v[4] = {acc[0][i][u], acc[0][i][2 + u], acc[1][i][u], acc[1][i][2 + u]};",
     "const float v[4] = {acc[0][i][u], acc[1][i][u], acc[0][i][2 + u], acc[1][i][2 + u]};"),
    ("wgmma_s8.cuh", "bf16 P: s8 operands' k32 step advanced 16 bytes, not 32 (d >= 64)",
     "  return sw128_desc(tile + 32 * kc);", "  return sw128_desc(tile + 16 * kc);"),
    ("flash_int8_fwd.cu", "bf16 P: scores converted as unsigned (negative ones near 2^32)",
     "__device__ __forceinline__ float s32_to_f32(int s) { return static_cast<float>(s); }",
     "__device__ __forceinline__ float s32_to_f32(int s) { return static_cast<float>(unsigned(s)); }"),
    ("flash_int8_fwd.cu", "bf16 P: V converted as unsigned (biased by 128)",
     "  const uint32_t u = w ^ 0x80808080u;", "  const uint32_t u = w;"),
    ("flash_int8_fwd.cu", "bf16 P: the ones column zero (l dropped)",
     "          make_uint4(BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES);",
     "          make_uint4(0u, 0u, 0u, 0u);"),
    ("flash_int8_fwd.cu", "bf16 P: an item's K and V copied into the next stage (stale reads)",
     "          issue(t0, kb1, sweep == 1, n);",
     "          issue(t0, kb1, sweep == 1, n + 1);"),
    ("flash_int8_fwd.cu", "bf16 P: V scale of the next quant block",
     "    const float v_scale = p.vs[sidx];",
     "    const float v_scale = p.vs[qb + 1 < p.nkv ? sidx + 1 : sidx];"),
    ("flash_int8_fwd.cu", "bf16 P: keys past a clipped tile's quant block kept",
     "const bool keep = kloc < tend && pair_valid(p, qpos_r[r], kv_off + kloc, kloc);",
     "const bool keep = pair_valid(p, qpos_r[r], kv_off + kloc, kloc);"),
    ("flash_int8_fwd.cu", "bf16 P: a warp's tile taken as mask-free when its last row sees it whole",
     "range_unmasked(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1);",
     "range_unmasked(p, wq_last, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1);"),
    ("flash_int8_fwd.cu", "bf16 P: each k16 step of P against the V rows of the neighbouring step",
     "for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(pv, a[kk], tile_desc_mn(vt, 16 * kk));",
     "for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(pv, a[kk], tile_desc_mn(vt, 16 * (kk ^ 1)));"),
    ("flash_int8_fwd.cu", "bf16 P: acc not rescaled by alpha (rows g)",
     "make_float4(x.x * alpha[0] + pv[c][0] * v_scale, x.y * alpha[0] + pv[c][1] * v_scale,",
     "make_float4(x.x + pv[c][0] * v_scale, x.y + pv[c][1] * v_scale,"),
    ("flash_int8_fwd.cu", "int8 P: Vᵀ's keys one step off (lane t's P against lane t + 1's keys)",
     "*reinterpret_cast<uint32_t*>(vt_of(s) + sw8(d, x.q) + 4 * x.ut) = col[k];",
     "*reinterpret_cast<uint32_t*>(vt_of(s) + sw8(d, x.q) + 4 * ((x.ut + 1) & 3)) = col[k];"),
    ("flash_int8_fwd.cu", "int8 P: P truncated, not rounded to nearest even",
     "x[u] = __float_as_uint(__fadd_rn(pe[u], 12582912.f));",
     "x[u] = __float_as_uint(__fadd_rz(pe[u], 12582912.f));"),
    ("flash_int8_fwd.cu", "int8 P: l sums the rounded P, not the f32 P'",
     "lsum[r] += (pe[0] + pe[1]) + (pe[2] + pe[3]);",
     "lsum[r] += (rintf(pe[0]) + rintf(pe[1])) + (rintf(pe[2]) + rintf(pe[3]));"),
    ("flash_int8_fwd.cu", "int8 P: V scale of the next quant block",
     "    const float vsc = p.vs[sidx];",
     "    const float vsc = p.vs[qb + 1 < p.nkv ? sidx + 1 : sidx];"),
    ("flash_int8_fwd.cu", "int8 P: acc not rescaled by alpha",
     "acc[j][e] = fmaf(acc[j][e], alpha[e >> 1], static_cast<float>(pvi[j][e]) * vsc);",
     "acc[j][e] = acc[j][e] + static_cast<float>(pvi[j][e]) * vsc;"),
    ("flash_int8_fwd.cu", "int8 P: keys past a clipped tile's quant block kept",
     "const bool keep = kloc < tend && pair_valid(p, qp[r], kv_off + kloc, kloc);",
     "const bool keep = pair_valid(p, qp[r], kv_off + kloc, kloc);"),
    ("flash_int8_fwd.cu", "int8 P: a warp's tile taken as mask-free when its last row sees it whole",
     "tend - t0 == TK && range_unmasked(p, wlo, whi, kv_off + t0, kv_off + tend - 1, tend - 1);",
     "tend - t0 == TK && range_unmasked(p, whi, whi, kv_off + t0, kv_off + tend - 1, tend - 1);"),
    ("flash_int8_fwd.cu", "int8 P: an item's K and V copied into the next stage (stale reads)",
     "          copy_item(t0, kb1, sw == 1, s);",
     "          copy_item(t0, kb1, sw == 1, (n + 1) % R::STAGES);"),
    ("flash_int8_fwd.cu", "d=256 int8 P: S's k32 steps 4-7 read the first 128-byte halves of Q and K",
     "    return s8_desc(tile + (kc >> 2) * (ROWS * S8_ROW), kc & 3);",
     "    return s8_desc(tile, kc & 3);"),
    ("flash_int8_fwd.cu", "d=256 int8 P: P·V's second column half against Vᵀ's first (O's columns 128-255)",
     "        const int8_t* vh = vt_of(n % R::STAGES) + 128 * cw * S8_ROW;  // Vᵀ of O's columns 128cw..",
     "        const int8_t* vh = vt_of(n % R::STAGES);  // Vᵀ of O's columns 128cw.."),
    ("flash_int8_fwd.cu", "d=256 int8 P: each consumer's P·V against the other's V columns",
     "        const int8_t* vh = vt_of(n % R::STAGES) + 128 * cw * S8_ROW;  // Vᵀ of O's columns 128cw..",
     "        const int8_t* vh = vt_of(n % R::STAGES) + 128 * (1 - cw) * S8_ROW;"),
    ("flash_int8_fwd.cu", "d=256 int8 P: acc in registers not rescaled by alpha (rows g, even columns)",
     "        acc[j][0] = fmaf(acc[j][0], alpha[0], static_cast<float>(pvh[j][0]) * vscale);",
     "        acc[j][0] = fmaf(acc[j][0], 1.f, static_cast<float>(pvh[j][0]) * vscale);"),
    ("flash_int8_fwd.cu", "d=256 int8 P: the second consumer's P half never written (stale bytes)",
     "            *reinterpret_cast<uint32_t*>(pt + sw8(16 * warp + g + 8 * r, 4 * pb + 2 * cw + hh) +",
     "            if (cw == 0) *reinterpret_cast<uint32_t*>(pt + sw8(16 * warp + g + 8 * r, 4 * pb + 2 * cw + hh) +"),
    ("flash_int8_fwd.cu", "d=256 int8 P: the row-max exchange skipped (each consumer its own keys' max)",
     "        const int imr = max(im[r], xo.x);",
     "        const int imr = im[r];"),
    ("flash_int8_fwd.cu", "d=256 int8 P: the other consumer's share of l not added at the end",
     "    for (int r = 0; r < 2; ++r) l[r] += xl[64 * (1 - cw) + 16 * warp + g + 8 * r];",
     "    for (int r = 0; r < 2; ++r) l[r] += 0.f * xl[64 * (1 - cw) + 16 * warp + g + 8 * r];"),
    ("flash_int8_fwd.cu", "d=256 bf16 P: the ones product (l) dropped for the last k16 step",
     "for (int kk = 0; kk < 2; ++kk) wgmma_rs_m64n8<0>(pl, a[kk], ones, kk | more);",
     "for (int kk = 0; kk < 1; ++kk) wgmma_rs_m64n8<0>(pl, a[kk], ones, kk | more);"),
    ("flash_int8_fwd.cu", "d=256 bf16 P: P·V's second column half against V's first (O's columns 128-255)",
     "        const __nv_bfloat16* vh = v_tile(n % R::STAGES) + 2 * cw * SW_ROWS * 64;",
     "        const __nv_bfloat16* vh = v_tile(n % R::STAGES);"),
    ("flash_int8_fwd.cu", "d=256 bf16 P: each consumer's P·V against the other's V columns",
     "        const __nv_bfloat16* vh = v_tile(n % R::STAGES) + 2 * cw * SW_ROWS * 64;",
     "        const __nv_bfloat16* vh = v_tile(n % R::STAGES) + 2 * (1 - cw) * SW_ROWS * 64;"),
    ("flash_int8_fwd.cu", "d=256 bf16 P: acc in registers not rescaled by alpha (rows g, even columns)",
     "        acc[j][0] = acc[j][0] * alpha[0] + pv[j][0] * vs_b;",
     "        acc[j][0] = acc[j][0] + pv[j][0] * vs_b;"),
    ("flash_int8_fwd.cu", "d=256 bf16 P: the second consumer's P half never written (stale bytes)",
     "              *reinterpret_cast<uint32_t*>(pb + sw(16 * warp + g + 8 * r, 4 * cw + 2 * kk + hh) +",
     "              if (cw == 0) *reinterpret_cast<uint32_t*>(pb + sw(16 * warp + g + 8 * r, 4 * cw + 2 * kk + hh) +"),
    ("flash_int8_fwd.cu", "d=256 bf16 P: the row-max exchange skipped (each consumer its own keys' max)",
     "        const int imr = max(xo.x, im[r]);",
     "        const int imr = im[r];"),
    ("flash_int8_fwd.cu", "d=256 bf16 P: the other consumer's share of l not added at the end",
     "    for (int r = 0; r < 2; ++r) l[r] += xl[64 - 64 * cw + 16 * warp + g + 8 * r];",
     "    for (int r = 0; r < 2; ++r) l[r] += 0.f * xl[64 - 64 * cw + 16 * warp + g + 8 * r];"),
    ("flash_int8_fwd.cu", "bf16 P, f32 l: l sums the bf16-rounded P', not the f32 P'",
     "if constexpr (F32L) lsum[r] += pe[0] + pe[1];  // l over the f32 P'",
     "if constexpr (F32L) lsum[r] += __low2float(pb) + __high2float(pb);"),
    ("flash_int8_fwd.cu", "bf16 P, f32 l: the quad sum of l misses one lane (t ^ 3)",
     "ls += __shfl_xor_sync(0xffffffffu, ls, 2);",
     "ls += __shfl_xor_sync(0xffffffffu, lsum[r], 2);"),
    ("flash_fwd.cu", "d=256 f32: O's second column half (columns 128-255) left unwritten",
     "for (int c4 = 0; c4 < T::CPT; c4 += 4)  // columns 4tx + 16c4 .. + 3",
     "for (int c4 = 0; c4 < T::CPT / 2; c4 += 4)  // columns 4tx + 16c4 .. + 3"),
    ("flash_fwd.cu", "d=256 f32: the window's tile skip one tile early (a tile's last key "
     "taken 64 keys back)",
     "kv_off + min(t0 + TILE_KEYS, p.Skv) - 1))",
     "kv_off + min(t0 + TILE_KEYS, p.Skv) - 1 - TILE_KEYS))"),
    ("paged_prefill.cu", "f32 q: V's f32 tile converted from K's stage (S's keys in P·V)",
     "const int4 raw = *reinterpret_cast<const int4*>(v8 + buf * S::STAGE + r * S::RB + 16 * c);",
     "const int4 raw = *reinterpret_cast<const int4*>(k8 + buf * S::STAGE + r * S::RB + 16 * c);"),
    ("paged_prefill.cu", "split: a split's key range one tile too long (the next split's first "
     "tile counted twice)",
     "  if (p.splits > 1) s.kend = min(s.kend, s.kstart + p.split_keys);",
     "  if (p.splits > 1) s.kend = min(s.kend, s.kstart + p.split_keys + BK);"),
    ("paged_prefill.cu", "split merge: an empty split not skipped (exp(-inf - -inf) where every "
     "split of a row is empty, its unwritten sums read)",
     "    if (ms == -INFINITY) continue;", "    if (false) continue;"),
    ("paged_prefill.cu", "split merge: a split's weight exp(m - M) dropped",
     "    const float w = expf(ms - mx);", "    const float w = 1.f;"),
    ("paged_prefill.cu", "split merge out of order: split s's sums taken with split s + 1's m "
     "and l",
     "    acc += w * p.part[(s * plane + row) * D + d];",
     "    acc += w * p.part[(((s + 1) % p.splits) * plane + row) * D + d];"),
    ("paged_prefill.cu", "split epilogue: a split's sums normalised by its own l",
     "make_float2(acc[c][2 * h], acc[c][2 * h + 1]);",
     "make_float2(acc[c][2 * h] * l_inv, acc[c][2 * h + 1] * l_inv);"),
    ("paged_prefill.cu", "f32 q: a key's K scale taken from the next key's page / INT4 sub-tile",
     "kss[tid] = ok ? p.ks[sidx] : 0.f;",
     "kss[tid] = ok ? p.ks[scale_index(p, rows, min(kpos + 1, kend - 1), true)] : 0.f;"),
)
# The kernel sources the faults are held to, and the prefixes of their
# coverage cases.
FAULT_SOURCES = {"flash_fwd": ("flash_fwd",), "paged_prefill": ("paged_prefill",),
                 "paged_decode": ("decode", "paged_decode"), "flash_bwd": ("flash_bwd",),
                 "w4_matmul": ("w4",), "flash_int8_fwd": ("fa8_",)}


def decode_coverage_inputs(g, case):
    """(operands of ops/decode._paged_decode_launch, its keywords with lse)
    of one DECODE_COVERAGE case on the card."""
    import torch
    B, Hq, Hkv, D, P, window, sinks, cap, qbf16, max_pages, lens, neg = case
    num_pages = B * max_pages + 1
    lengths = torch.randint(1, P * max_pages + 1, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
    if lens is not None:
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tables = (torch.randperm(num_pages - 1, generator=g, device="cuda")[:B * max_pages]
              + 1).reshape(B, max_pages).to(torch.int32)
    k_pages, v_pages = torch.randint(-127, 128, (2, Hkv, num_pages, P, D), generator=g,
                                     device="cuda", dtype=torch.int8)
    k_scales, v_scales = torch.rand((2, Hkv, num_pages), generator=g, device="cuda") * 0.05
    dt = torch.bfloat16 if qbf16 else torch.float32
    q = torch.randn((B, Hq, D), generator=g, device="cuda")
    if neg:
        q, k_pages = -(q.abs() + 1.0) * 400.0, k_pages.abs() + 1
    q = q.to(dt)
    kw = dict(sm_scale=D**-0.5, window=window, softcap=cap, sinks=sinks, save_residuals=True)
    return (q, k_pages, v_pages, k_scales, v_scales, lengths, tables), kw


def _decode_coverage_ratios(g):
    """DECODE_COVERAGE: the INT8 decode kernel against plain on the card,
    each case launched twice, {case: [output, lse] err_over_tol} (a third
    entry, inf, when the second launch's bits differ)."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    ratios = {}
    for i, case in enumerate(DECODE_COVERAGE):
        operands, kw = decode_coverage_inputs(g, case)
        q, k_pages, v_pages, k_scales, v_scales, lengths, tables = operands
        D, cap, neg = q.shape[-1], kw["softcap"], case[-1]
        kernel, args, (out, lse), _operands = dec._paged_decode_launch(*operands, **kw)
        kernel(*args)
        torch.cuda.synchronize()
        same = _same_bits_again(lambda: kernel(*args), (out, lse))
        p_out, p_lse = dec._paged_decode_plain(*operands, **kw)
        if neg:
            # Scores of hundreds: their summation-order error counts (score_err).
            tol, lse_tol = paged_prefill_tolerances(q, k_pages, v_pages, k_scales, v_scales,
                                                    p_out, p_lse, sm_scale=D**-0.5,
                                                    softcap=cap)
        else:
            tol = decode_tolerance(p_out, v_pages, v_scales)
            # lse: f32 on both sides, summation order only.
            lse_tol = 1e-5 + 1e-6 * torch.nan_to_num(p_lse.double().abs(), posinf=0.0)
        ratios[f"decode{i}"] = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
        if not same:
            ratios[f"decode{i}"].append(float("inf"))
    return ratios


def _w4_fault_ratios(g, g5):
    """w4_matmul's checks with whatever library is bound: ({W4_MAIN matmul
    at R = 8 and 32: [err_over_tol vs plain, vs golden]}, {W4_COVERAGE
    case: [the same]}); a second launch with other bits adds inf."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import quantize_weight4

    def ratios(x, w, layer=None):
        e = _w4_case(x, w, layer, timed=False)
        return [e["err_over_tol"], e["golden_err_over_tol"]] + (
            [] if e["bitwise_repeat"] else [float("inf")])
    main = {}
    for name, in_dim, n in W4_MAIN:
        w = quantize_weight4(torch.randn((in_dim, n), generator=g, device="cuda") * in_dim**-0.5,
                             group=128, packing="halves")
        for R in (8, 32):
            x = torch.randn((R, in_dim), generator=g, device="cuda").to(torch.bfloat16)
            main[f"{name} R={R}"] = ratios(x, w)
    cov = {}
    for i, (R, in_dim, n, group, packing, f32, layer) in enumerate(W4_COVERAGE):
        shape = (in_dim, n) if layer is None else (3, in_dim, n)
        w = quantize_weight4(torch.randn(shape, generator=g5, device="cuda"), group=group,
                             packing=packing)
        x = torch.randn((R, in_dim), generator=g5, device="cuda")
        cov[f"w4_{i}"] = ratios(x if f32 else x.to(torch.bfloat16), w, layer)
    return main, cov


def _fault_checks(src):
    """The kernel checks of one source with whatever library is bound:
    ({main shape: [err_over_tol]}, {coverage case: err_over_tol})."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    g = torch.Generator(device="cuda").manual_seed(1)
    g5 = torch.Generator(device="cuda").manual_seed(5)
    main = {}
    if src == "flash_fwd":
        for label, dt, shape, hkv, causal in (
                ("serve_flash prefill", torch.bfloat16, (1, 32, 2048, 128), 8, True),
                ("solve fa", torch.float32, (1, 32, 8192, 32), 32, False)):
            q = torch.randn(shape, generator=g, device="cuda").to(dt)
            kv = torch.randn((2, 1, hkv) + shape[2:], generator=g, device="cuda").to(dt)
            main[label] = _flash_fwd_check(q, kv[0], kv[1], _offsets(0, 0, 1, q.device),
                                           causal=causal, save_residuals=False)[2]
        ratios, _ = _coverage_float(g5)
        ratios.update(_coverage_d256(("flash",), small=True))
    elif src == "flash_bwd":
        B, H, Hkv, S, D = (BWD_MAIN[x] for x in ("B", "H", "Hkv", "S", "D"))
        q = torch.randn((B, H, S, D), generator=g, device="cuda").to(torch.bfloat16)
        k, v = torch.randn((2, B, Hkv, S, D), generator=g, device="cuda").to(torch.bfloat16)
        do = torch.randn((B, H, S, D), generator=g, device="cuda").to(torch.bfloat16)
        main["train step"] = _flash_bwd_check(q, k, v, _offsets(0, 0, B, q.device), do,
                                              causal=True)[2]
        ratios = _coverage_bwd(g5)
    elif src == "w4_matmul":
        main, ratios = _w4_fault_ratios(g, g5)
    elif src == "flash_int8_fwd":
        # solve's shape (MODE_BF16_P) and the serve and serve_w4 prefills'
        # (MODE_INT8_P); then FLASH_COVERAGE.
        for name, mode, shape, hkv, dt, bkv, causal in (
                ("solve fa_int8", 1, (1, 32, 8192, 32), 32, torch.float32, 512, False),
                ("serve prefill", 0, (1, 32, 256, 128), 8, torch.bfloat16, 256, True),
                ("serve_w4 prefill", 0, (1, 32, 512, 128), 8, torch.bfloat16, 512, True),
                ("serve_hf prefill", 0, (1, 16, 512, 256), 8, torch.bfloat16, 512, True)):
            q = torch.randn(shape, generator=g, device="cuda").to(dt)
            k, v = torch.randn((2, 1, hkv) + shape[2:], generator=g, device="cuda").to(dt)
            e = _flash_case(name, mode, q, k, v, bkv, causal, replaces=None, library=False,
                            timed=False)
            main[name] = [e["err_over_tol"]] + ([] if e["same_bits_twice"] else [float("inf")])
        ratios = _flash_coverage_ratios(g5)
    elif src == "paged_prefill":
        main["serve_flash chunk"] = _paged_prefill_check(*_paged_main_inputs(g))[2]
        q, cache, lengths, tables, q_starts = _int4_prefill_main_inputs(g)
        main["serve_mixed chunk"] = _int4_check(q, cache, lengths, tables, q_starts)[2]
        ratios = {**_coverage_float(g5)[0], **_coverage_int4(g5),
                  **_coverage_d256(("prefill",), small=True), **_coverage_verify()}
    else:
        kw = dict(sm_scale=128**-0.5, window=None, softcap=None, sinks=0, save_residuals=False)
        for label, (hkv, seed, lens, slots) in DECODE_MAIN.items():
            operands = _decode_main_inputs(hkv, seed=seed, lengths=lens, max_pages=slots)
            main[label] = [_decode_check(operands, kw)[2]]
        main["serve_mixed decode"] = _int4_check(*_int4_decode_main_inputs(g))[2]
        ratios = {**_decode_coverage_ratios(g5), **_coverage_int4(g5),
                  **_coverage_d256(("decode",), small=True)}
    return main, {k: max(r) for k, r in ratios.items() if k.startswith(FAULT_SOURCES[src])}


class _FaultBuilds:
    """The faults phase's libraries: each PLANTED_FAULTS line planted in a
    copy of csrc/, and every kernel source that the changed file is part of
    built from it by nvcc, at most `workers` at a time, the largest sources
    first. main() starts them right after the build phase, niced and on all
    but two cores, so that they use the CPU time the other phases leave
    idle (the builds bound the faults phase: ~84 nvcc runs of 17-60 s).
    `builds`: (fault, source, .cu, library) in PLANTED_FAULTS order;
    `futures`: {future: index into builds}, each future's result the
    seconds from the start to its build's end."""

    def __init__(self, workers, nice):
        import concurrent.futures
        import shutil
        from quantizedmha_tpu_torch.ops import cuda_lib
        out_dir = cuda_lib.BUILD_DIR / "faults"
        shutil.rmtree(out_dir, ignore_errors=True)
        self.t0 = time.perf_counter()
        self.builds = []
        for i, (fname, what, old, new, *only) in enumerate(PLANTED_FAULTS):
            text = (cuda_lib.CSRC / fname).read_text()
            if text.count(old) != 1:
                raise AssertionError(f"fault {i}: the committed line is not unique in {fname}")
            copy = out_dir / f"fault{i}"
            shutil.copytree(cuda_lib.CSRC, copy)
            (copy / fname).write_text(text.replace(old, new))
            srcs = only[0] if only else [
                s for s in FAULT_SOURCES if fname == f"{s}.cu"
                or f'#include "{fname}"' in (cuda_lib.CSRC / f"{s}.cu").read_text()]
            for src in srcs:
                self.builds.append((what, src, copy / f"{src}.cu", copy / f"lib{src}.so"))
        self.prefix = ["nice", "-n", "19"] if nice and shutil.which("nice") else []
        self.procs = set()
        self.stopped = False
        self.lock = threading.Lock()
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
        self.futures = {self.pool.submit(self._build, job): i for i, job in
                        sorted(enumerate(self.builds), key=lambda ij: -ij[1][2].stat().st_size)}

    def _build(self, job):
        from quantizedmha_tpu_torch.ops import cuda_lib
        _, _, cu, lib = job
        with self.lock:
            if self.stopped:
                raise RuntimeError("fault builds stopped")
            # A session of its own: stop() ends nvcc's cicc and ptxas too.
            proc = subprocess.Popen([*self.prefix, cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                                     str(lib), str(cu)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, start_new_session=True)
            self.procs.add(proc)
        log = proc.communicate()[0].decode(errors="replace")
        with self.lock:
            self.procs.discard(proc)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for a planted fault:\n{log}")
        return time.perf_counter() - self.t0

    def stop(self):
        """Ends every build still queued or running (a failed run)."""
        with self.lock:
            self.stopped = True
            for proc in self.procs:
                os.killpg(proc.pid, signal.SIGKILL)
        self.pool.shutdown(wait=True, cancel_futures=True)


def phase_faults(st):
    """Bind each _FaultBuilds library in place of the committed one as its
    build ends and rerun that kernel's main-shape and coverage checks while
    the other builds go on: every fault must fail them, a fault of the
    d=256 backward ("d=256 ..." in flash_bwd.cu) or of the f32 kernels that
    run every head dim, d=256 too ("f32 ..."), a d=256 coverage case by
    10x or more, and so must a fault of the d=256 int8-P forward ("d=256
    int8 P: ...", a d=256 int8-P coverage case or serve_hf's prefill) and
    one of the d=256 bf16-P forward ("d=256 bf16 P: ...", a d=256 bf16-P
    coverage case). The builds are main()'s, started after the build phase,
    or started here on every core."""
    import concurrent.futures
    import ctypes
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.ops import w4_matmul as w4
    fb = st.pop("fault_builds", None) or _FaultBuilds(os.cpu_count() or 8, nice=False)
    t_phase = time.perf_counter()
    done_before = sum(f.done() for f in fb.futures)
    builds, futures = fb.builds, fb.futures
    kernels = {"flash_fwd": (fa.FLASH_FWD_BF16, fa.FLASH_FWD_F32),
               "paged_prefill": (pp.PAGED_PREFILL, pp.PAGED_PREFILL_INT4),
               "paged_decode": (dec.PAGED_DECODE, dec.PAGED_DECODE_INT4),
               "flash_bwd": (fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ),
               "w4_matmul": (w4.W4_MATMUL,),
               "flash_int8_fwd": (fa8.FLASH_INT8_P, fa8.FLASH_BF16_P, fa8.FLASH_BF16_P_F32L)}
    rows = {}
    build_s = 0.0
    try:
        for fut in concurrent.futures.as_completed(futures):
            build_s = max(build_s, fut.result())
            what, src, _, lib = builds[futures[fut]]
            t_check = time.perf_counter()
            # Every other source's kernels from the committed library: the
            # backward's checks run the forward (o, lse), which a planted
            # forward fault left bound would corrupt on both sides.
            for kerns in kernels.values():
                for kern in kerns:
                    kern._fn = None
            variant = ctypes.CDLL(str(lib))
            for kern in kernels[src]:
                fn = getattr(variant, kern.symbol)
                fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
                kern._fn = fn
            main, cov = _fault_checks(src)
            worst = max([max(r) for r in main.values()] + list(cov.values()))
            # A fault of the d=256 backward, of the f32 kernels or of the
            # d=256 int8-P or bf16-P forward must fail a d=256 case by 10x
            # (the bf16-P ones a d=256 bf16-P case).
            d256 = None
            if src == "flash_bwd" and what.startswith(("d=256", "f32")):
                d256 = max([cov[f"flash_bwd{i}"] for i, c in enumerate(FLASH_BWD_COVERAGE)
                            if c[5] == 256]
                           + [cov[f"flash_bwd_grid{i}"] for i in range(len(FLASH_BWD_GRID))])
            elif src == "flash_int8_fwd" and what.startswith("d=256 int8 P"):
                d256 = max([cov[f"fa8_{i}"] for i, c in enumerate(FLASH_COVERAGE)
                            if c[6] == 256 and c[12] == 0] + main["serve_hf prefill"])
            elif src == "flash_int8_fwd" and what.startswith("d=256 bf16 P"):
                d256 = max(cov[f"fa8_{i}"] for i, c in enumerate(FLASH_COVERAGE)
                           if c[6] == 256 and c[12] != 0)
            rows[futures[fut]] = {
                "source": src, "fault": what, "main_err_over_tol": main,
                "coverage_failing": sorted(k for k, r in cov.items() if r > 1.0),
                "coverage_err_over_tol": cov, "max_err_over_tol": worst,
                "d256_max_err_over_tol": d256,
                "caught": worst > 1.0 and (d256 is None or d256 >= 10.0),
                "check_s": round(time.perf_counter() - t_check, 2)}
    finally:
        fb.stop()
        for kerns in kernels.values():
            for kern in kerns:
                kern._fn = None  # rebind the committed kernel at its next call
    rows = [rows[i] for i in sorted(rows)]
    ok = len(rows) == len(builds) and all(r["caught"] for r in rows)
    # build_s: from the builds' start to the last one's end (the checks
    # ran meanwhile); built_before_phase: the builds done when it began.
    emit({"phase": "faults", "ok": ok, "builds": len(builds), "build_s": round(build_s, 1),
          "built_before_phase": done_before,
          "last_build_end_in_phase_s": round(max(0.0, fb.t0 + build_s - t_phase), 1),
          "faults": rows})
    if not ok:
        raise AssertionError("a planted fault passed the kernel checks")


def phase_solve(st):
    import torch
    from quantizedmha_tpu_torch import solve
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    N, d_model, h = 8192, 1024, 32
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn((N, d_model), generator=g, device="cuda") for _ in range(3))
    for kern in (fa8.FLASH_INT8_P, fa8.FLASH_BF16_P):
        kern.reset()
    out = solve(q, k, v, d_model, h, kernel="fa_int8")
    torch.cuda.synchronize()
    launches = {"flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches,
                "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches}
    st["launches"].update({"flash_int8_fwd[bf16_p]": launches["flash_int8_fwd[bf16_p]"]})
    ms = _solve_ms(lambda: solve(q, k, v, d_model, h, kernel="fa_int8"))
    # Random inputs: the int8 Q/K/V quantization error against the float
    # golden, as the RMS of the error over the RMS of the golden. Each
    # quantizer's step is 1/127 of its block's max|x| (about 1% of the RMS of
    # a normal block), and the plain int8 version lands at 1.4% on these
    # inputs at N=2048, so the limit is 3%: a fault that is off by a few per
    # cent across the output (a wrong V scale, say) exceeds it, while the
    # per-element check against the plain version (kernels phase) holds
    # the kernel itself far tighter.
    ref = solve(q, k, v, d_model, h, kernel="reference")
    rel_rms = ((out - ref).norm() / ref.norm()).item()
    max_abs = (out - ref).abs().max().item()
    finite = bool(torch.isfinite(out).all().item())
    ones = torch.ones((N, d_model), device="cuda")
    const_dev = (solve(ones, ones, ones, d_model, h, kernel="fa_int8") - 1.0).abs().max().item()
    ok = (launches["flash_int8_fwd[bf16_p]"] == 1 and finite and rel_rms <= SOLVE_REL_RMS_TOL
          and tuple(out.shape) == (N, d_model) and const_dev <= 1e-6)
    rungs = {name: _solve_rung(name, q, k, v, ref, ones, st) for name in SOLVE_RUNG_TOL}
    st["solve_ms"] = {"fa_int8": ms, **{name: r["ms"] for name, r in rungs.items()}}
    # Gemma-2's head dim through the reference ABI: the fa rung at d_model
    # 4096 over h 16 (d = 256, the f32 kernel's CUDA-core route), gated as
    # fa is.
    g2 = torch.Generator(device="cuda").manual_seed(6)
    q2, k2, v2 = (torch.randn((N, 4096), generator=g2, device="cuda") for _ in range(3))
    ref2 = solve(q2, k2, v2, 4096, 16, kernel="reference")
    rungs["fa_d256"] = _solve_rung("fa", q2, k2, v2, ref2, torch.ones((N, 4096), device="cuda"),
                                   st, h=16)
    del q2, k2, v2, ref2
    torch.cuda.empty_cache()
    ok = ok and all(r["ok"] for r in rungs.values())
    emit({"phase": "solve", "ok": ok, "ms": ms, "launches": launches,
          "rel_rms_err_vs_reference": rel_rms, "rel_rms_tol": SOLVE_REL_RMS_TOL,
          "max_abs_err_vs_reference": max_abs, "ref_rms": (ref.norm() / N**0.5 / d_model**0.5).item(),
          "ones_max_dev": const_dev, "ones_tol": 1e-6,
          "reference_l4_ms": REFERENCE_L4_MS, "rungs": rungs})
    if not ok:
        raise AssertionError("solve failed its checks")


# The float rungs of the solve ladder: relative RMS error limit against the
# float golden, and the kernel each launches once a call. fa and unfused
# compute in f32 and differ from the golden by summation order alone
# (~1e-7); fa_bf16 rounds Q, K, V and P to bf16 (2^-9 relative each, ~0.3%
# RMS at the output on random inputs), so a fault that moves the output by
# a few per cent exceeds its 1% limit.
SOLVE_RUNG_TOL = {"fa": (1e-5, "flash_fwd[f32]"), "fa_bf16": (1e-2, "flash_fwd[bf16]"),
                  "unfused": (1e-5, None)}


def _solve_ms(fn):
    """A solve call's time as the harness phase's CLI estimates it (the
    median of `repeats` samples of `runs` calls after `warmup`), so that the
    band HARNESS_MS_BAND holds two estimates of like spread."""
    return cuda_ms_median(fn, iters=HARNESS_ARGS["runs"], samples=HARNESS_ARGS["repeats"],
                          warmup=HARNESS_ARGS["warmup"])


def _solve_rung(kernel, q, k, v, ref, ones, st, h=32):
    """One float rung at the reference workload (or at d_model / h = 256):
    launches of its kernel in one call (counts zeroed just before), time
    (CUDA events), error against the golden, the all-ones gate."""
    import torch
    from quantizedmha_tpu_torch import solve
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    N, d_model = q.shape
    tol, name = SOLVE_RUNG_TOL[kernel]
    counters = {"flash_fwd[f32]": fa.FLASH_FWD_F32, "flash_fwd[bf16]": fa.FLASH_FWD_BF16}
    for c in counters.values():
        c.reset()
    out = solve(q, k, v, d_model, h, kernel=kernel)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    if name is not None:
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    ms = _solve_ms(lambda: solve(q, k, v, d_model, h, kernel=kernel))
    rel_rms = ((out - ref).norm() / ref.norm()).item()
    const_dev = (solve(ones, ones, ones, d_model, h, kernel=kernel) - 1.0).abs().max().item()
    want = {n: int(n == name) for n in counters}
    ok = (launches == want and bool(torch.isfinite(out).all().item()) and rel_rms <= tol
          and out.dtype == torch.float32 and const_dev <= 1e-6)
    return {"ok": ok, "ms": ms, "launches": launches, "rel_rms_err_vs_reference": rel_rms,
            "rel_rms_tol": tol, "ones_max_dev": const_dev, "ones_tol": 1e-6,
            "shape": {"N": N, "d_model": d_model, "h": h, "head_dim": d_model // h}}


# int8_modes: each INT8 numerics mode through the public entry points.
#   (label, entry, (B, Hq, Hkv, S, D), bf16 inputs, keywords, kernel name,
#    route: "t" transposed, block_kv 512 by pick_blocks_t, or "std", 1024 by
#    pick_blocks): Gemma-2-9B's attention
# (GEMMA2_ATTN) at 2048 tokens on the transposed route (mode 1, then its
# summode="vpu" twin, mode 2) and at 8192 under the 4096 window, the
# standard route with pv_dtype="bf16" (mode 2, block_kv 1024), and the
# reference workload (N=8192, h=32, d=32, f32) through
# flash_attention_int8_t with summode "mxu" and "vpu".
INT8_MODES = (
    ("gemma2 transposed mxu", "flash_attention_int8", (1, 16, 8, 2048, 256), True,
     dict(causal=True, logit_softcap=50.0, transposed=True), "flash_int8_fwd[bf16_p]", "t"),
    ("gemma2 transposed vpu", "flash_attention_int8", (1, 16, 8, 2048, 256), True,
     dict(causal=True, logit_softcap=50.0, transposed=True, summode="vpu"),
     "flash_int8_fwd[bf16_p_f32l]", "t"),
    ("gemma2 transposed mxu window", "flash_attention_int8", (1, 16, 8, 8192, 256), True,
     dict(causal=True, logit_softcap=50.0, transposed=True, window=4096),
     "flash_int8_fwd[bf16_p]", "t"),
    ("gemma2 standard bf16 P", "flash_attention_int8", (1, 16, 8, 2048, 256), True,
     dict(causal=True, logit_softcap=50.0, pv_dtype="bf16"), "flash_int8_fwd[bf16_p_f32l]",
     "std"),
    ("solve shape mxu", "flash_attention_int8_t", (1, 32, 32, 8192, 32), False,
     dict(summode="mxu"), "flash_int8_fwd[bf16_p]", "t"),
    ("solve shape vpu", "flash_attention_int8_t", (1, 32, 32, 8192, 32), False,
     dict(summode="vpu"), "flash_int8_fwd[bf16_p_f32l]", "t"),
)


def phase_int8_modes(st):
    """Each INT8_MODES call through the port's public API (the quantize
    prepass and the routing included), the launch counts zeroed just
    before and read just after. Gates: exactly one launch of its mode's
    kernel and none of the others; the output within flash_tolerances of
    _flash_int8_plain on the K/V quantized as the route quantizes them;
    relative RMS error against the float golden (mha_masked_reference)
    <= SOLVE_REL_RMS_TOL; all-ones inputs giving ones within 1e-6. Prints
    each call's ms (CUDA events, the prepass included)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.reference.mha import mha_masked_reference
    dev = st.get("device", "cuda")
    counters = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
                "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P,
                "flash_int8_fwd[bf16_p_f32l]": fa8.FLASH_BF16_P_F32L}
    g = torch.Generator(device=dev).manual_seed(25)
    rows, ok = [], True
    for label, entry, (B, Hq, Hkv, S, D), bf16, kw, name, route in INT8_MODES:
        fn = getattr(fa8, entry)
        dt = torch.bfloat16 if bf16 else torch.float32
        q = torch.randn((B, Hq, S, D), generator=g, device=dev).to(dt)
        k, v = torch.randn((2, B, Hkv, S, D), generator=g, device=dev).to(dt)
        for c in counters.values():
            c.reset()
        out = fn(q, k, v, **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        mode = 2 if name.endswith("f32l]") else 1
        bkv = (fa8.pick_blocks_t if route == "t" else fa8.pick_blocks)(S, S, D)[1]
        k_i8, ks, v_i8, vs = fa8._quantize_padded(k, v, bkv, 1e-8)
        pkw = dict(sm_scale=D**-0.5, causal=kw.get("causal", False), kv_len=S, block_kv=bkv,
                   scale_clamp=1e-8, p_scale=127.0, window=kw.get("window"),
                   softcap=kw.get("logit_softcap"), sinks=0, mode=mode)
        operands = (q, k_i8, ks, v_i8, vs, fa8._offsets(0, 0, B, dev))
        plain = fa8._flash_int8_plain(*operands, save_residuals=False, **pkw)
        _, _, l = fa8._flash_int8_plain_state(*operands, **pkw)
        tol, _ = flash_tolerances(plain, None, l, v_i8, vs, bkv, mode)
        ratio = err_over_tol(out, plain, tol)
        del plain, l, tol, k_i8, v_i8
        ref = mha_masked_reference(q.float(), k.float(), v.float(), sm_scale=D**-0.5,
                                   causal=pkw["causal"], window=pkw["window"],
                                   softcap=pkw["softcap"])
        rel_rms = ((out.float() - ref).norm() / ref.norm()).item()
        del ref
        ones = torch.ones_like(q)
        ones_dev = (fn(ones, ones[:, :Hkv], ones[:, :Hkv], **kw).float() - 1.0).abs().max().item()
        ms = cuda_ms(lambda: fn(q, k, v, **kw), iters=5) if dev == "cuda" else None
        want = {n: int(n == name) for n in counters}
        row_ok = (launches == want and ratio <= 1.0 and rel_rms <= SOLVE_REL_RMS_TOL
                  and ones_dev <= 1e-6 and tuple(out.shape) == (B, Hq, S, D)
                  and bool(torch.isfinite(out.float()).all()))
        rows.append({"call": label, "entry": entry, "kwargs": kw, "kernel": name, "mode": mode,
                     "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "q": str(dt),
                               "block_kv": bkv},
                     "launches": launches, "err_over_tol": ratio, "rel_rms_err": rel_rms,
                     "rel_rms_tol": SOLVE_REL_RMS_TOL, "ones_max_dev": ones_dev, "ms": ms,
                     "ok": row_ok})
        ok &= row_ok
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
        if D == 256:
            st["launches_d256"][name] = st["launches_d256"].get(name, 0) + launches[name]
        del q, k, v, out, ones
        if dev == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "int8_modes", "ok": ok, "calls": rows})
    if not ok:
        raise AssertionError("an INT8 numerics mode failed its checks")


# The harness phase: the kernel counter each rung of the reference driver
# launches (none for unfused and reference), and the band its CLI time must
# lie in around the solve phase's time of the same rung.
HARNESS_RUNG_KERNELS = {"fa_int8": "flash_int8_fwd[bf16_p]", "fa": "flash_fwd[f32]",
                        "fa_bf16": "flash_fwd[bf16]"}
# A rung of a few ms varies more from one window of 16 calls to the next
# than within a window, and a single sample can be far off, so each side of
# the band is the median of 9 such samples (_solve_ms, the CLI's --repeats).
HARNESS_MS_BAND = (0.8, 1.25)
HARNESS_ARGS = dict(warmup=3, runs=16, repeats=9)


def phase_harness(st):
    """The reference driver (harness/cli.py) at solve's workload, all rungs,
    through the CLI's own entry with a temporary cache and JSON report."""
    import tempfile
    import torch
    from quantizedmha_tpu_torch.harness import cli
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.profiling.device_info import device_info
    counters = {"flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P,
                "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
                "flash_fwd[f32]": fa.FLASH_FWD_F32, "flash_fwd[bf16]": fa.FLASH_FWD_BF16}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "run.json")
        argv = ["--kernel", "all", "--n", "8192", "--d-model", "1024", "--heads", "32",
                "--cache-dir", os.path.join(tmp, "cache"), "--json", report]
        for key, val in HARNESS_ARGS.items():
            argv += [f"--{key}", str(val)]
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        rc = cli.run(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        with open(report) as f:
            payload = json.load(f)
    torch.cuda.empty_cache()
    results = payload["results"]
    # Every checked and timed rung calls solve 1 + warmup + runs * repeats times.
    calls = 1 + HARNESS_ARGS["warmup"] + HARNESS_ARGS["runs"] * HARNESS_ARGS["repeats"]
    want = {n: 0 for n in counters}
    want.update({n: calls for n in HARNESS_RUNG_KERNELS.values()})
    for n in HARNESS_RUNG_KERNELS.values():
        st["launches"][n] = st["launches"].get(n, 0) + launches[n]
    ratios = {r["kernel"]: r["ms"] / st["solve_ms"][r["kernel"]] for r in results
              if r["kernel"] in st["solve_ms"] and r["ms"]}
    lo, hi = HARNESS_MS_BAND
    checks = {
        "rc": rc == 0, "launches": launches == want,
        "rungs": [r["kernel"] for r in results] == ["unfused", "fa", "fa_bf16", "fa_int8",
                                                    "reference"],
        "results": all(r["error"] is None and r["skipped"] is None and r["check"]
                       and r["check"]["n_mismatch"] == 0 and r["check"]["n_nonfinite"] == 0
                       and r["ms"] and r["ms"] > 0
                       and 0 <= r["pct_mxu_sol"] <= 100 and 0 <= r["pct_hbm_sol"] <= 100
                       for r in results),
        "ms_band": len(ratios) == 4 and all(lo <= x <= hi for x in ratios.values())}
    ok = all(checks.values())
    emit({"phase": "harness", "ok": ok, "checks": checks, "rc": rc, "seconds": secs,
          "argv": argv, "device": payload["device"], "workload": payload["workload"],
          "results": results, "launches": launches, "launches_expected": want,
          "ms_over_solve_ms": ratios, "ms_band": HARNESS_MS_BAND,
          "device_info": device_info()})
    if not ok:
        raise AssertionError(
            f"the reference driver failed its checks: "
            f"{sorted(k for k, v in checks.items() if not v)}; ms / solve_ms {ratios}, "
            f"band {HARNESS_MS_BAND}; launches {launches}, expected {want}")


def phase_serve(st):
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.harness import serving_bench
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.quant.weights import quantize_llama_params, weight_bytes
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attention_impl="flash_int8")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_llama_params(llama.init_params(cfg, gen, device="cuda"), bits=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    wbytes = weight_bytes(params)

    batch, prompt_len, max_new, chunk, page = 8, 256, 32, 8, 128
    mpps = -(-(prompt_len + max_new + chunk + 1) // page)
    ecfg = EngineConfig(num_pages=batch * mpps + 2, page_size=page, max_batch=batch,
                        max_pages_per_seq=mpps, prefill_buckets=(prompt_len,),
                        max_new_tokens=max_new, decode_chunk=chunk)
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist() for _ in range(batch)]
    # A warm-up request outside the measured run (first cuBLAS/kernel use).
    eng.add_request(prompts[0][:100], max_new=chunk + 1)
    eng.run()
    eng.finished.clear()

    kernels = (fa8.FLASH_INT8_P, fa8.FLASH_BF16_P, dec.PAGED_DECODE)
    for kern in kernels:
        kern.reset()
    admitted0 = eng.metrics.counter("requests_admitted")
    steps0 = eng.metrics.counter("decode_steps")
    rids = [eng.add_request(p, max_new=max_new) for p in prompts]
    t0 = time.perf_counter()
    eng.step()  # 8 admissions (prefills) + the first fused chunk
    first_step_s = time.perf_counter() - t0
    toks0 = eng.metrics.counter("tokens_generated")
    sd0 = eng.metrics.counter("decode_steps")
    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    toks = eng.metrics.counter("tokens_generated") - toks0
    steps = eng.metrics.counter("decode_steps") - sd0

    # Warm TTFT: one fresh request on the drained engine, admission to its
    # first decoded token (prefill + one fused chunk + host turnaround).
    before = eng.metrics.counter("tokens_generated")
    t1 = time.perf_counter()
    eng.add_request(prompts[1], max_new=max_new)
    while eng.metrics.counter("tokens_generated") == before and (eng.queue or eng.active):
        eng.step()
    ttft = time.perf_counter() - t1
    eng.run()
    launches = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches,
                "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches,
                "paged_decode": dec.PAGED_DECODE.launches}
    admitted = eng.metrics.counter("requests_admitted") - admitted0
    decode_steps = eng.metrics.counter("decode_steps") - steps0
    st["launches"].update({"flash_int8_fwd[int8_p]": launches["flash_int8_fwd[int8_p]"],
                           "paged_decode": launches["paged_decode"]})

    lens_ok = all(len(results.get(r, [])) == max_new for r in rids)
    in_vocab = all(0 <= t < cfg.vocab_size for r in rids for t in results.get(r, []))
    want = {"flash_int8_fwd[int8_p]": cfg.num_layers * admitted,
            "paged_decode": cfg.num_layers * decode_steps}
    counts_ok = (launches["flash_int8_fwd[int8_p]"] == want["flash_int8_fwd[int8_p]"]
                 and launches["paged_decode"] == want["paged_decode"]
                 and launches["flash_int8_fwd[bf16_p]"] == 0)

    # Right by the repo's own means: the int8 prefill's last-token logits
    # against the same model with the plain float attention golden
    # (attention_impl="reference"), as the JAX package's engine tests do.
    toks_t = torch.tensor([prompts[2]], dtype=torch.int32, device="cuda")
    logits, _, _ = llama_adapter.prefill_at(cfg, params, toks_t, prompt_len - 1)
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    ref = llama.forward(ref_cfg, params, toks_t)[:, -1]
    finite = bool(torch.isfinite(logits).all().item())
    rel = ((logits - ref).abs().max() / ref.std()).item()
    ok = (lens_ok and in_vocab and counts_ok and not eng.failed and finite
          and rel <= 0.25)
    if st.get("profile"):
        emit({"phase": "serve_profile", **_profile_decode_chunk(eng, prompts, max_new)})
    # The serving benchmark's prefill on the same params: every layer's
    # attention through the int8-P kernel in each of its timed calls.
    torch.cuda.empty_cache()
    fa8.FLASH_INT8_P.reset()
    fa8.FLASH_BF16_P.reset()
    prefill = serving_bench.run_prefill_bench(cfg, params, prompt_len=PREFILL_BENCH_LEN)
    torch.cuda.synchronize()
    prefill_launches = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches,
                        "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches}
    timing = serving_bench.PREFILL_TIMING
    prefill_want = {"flash_int8_fwd[int8_p]": cfg.num_layers * (
                        timing["warmup"] + timing["runs"] * timing["repeats"]),
                    "flash_int8_fwd[bf16_p]": 0}
    st["launches"]["flash_int8_fwd[int8_p]"] += prefill_launches["flash_int8_fwd[int8_p]"]
    prefill_ok = (prefill_launches == prefill_want and prefill["prefill_ms"] > 0
                  and 0 < prefill["prefill_pct_mxu_sol"] <= 100)
    ok = ok and prefill_ok
    if st.get("profile"):
        bench_toks = torch.as_tensor(
            np.random.default_rng(0).integers(1, cfg.vocab_size, (1, PREFILL_BENCH_LEN)),
            dtype=torch.int32, device="cuda")
        emit({"phase": "serve_prefill_profile", "prefill_len": PREFILL_BENCH_LEN,
              **_profile_prefill(lambda: llama_adapter.prefill_at(
                  cfg, params, bench_toks, PREFILL_BENCH_LEN - 1))})
    st["serve_streams"] = [results[r] for r in rids]  # serve_tp's unsharded side
    if st.get("keep_serve_params"):  # serve_w8a8 serves the same params in w8a8
        st["serve_params"] = params
    st["serve_prefill_ms"] = prefill["prefill_ms"]
    emit({"phase": "serve", "ok": ok, "model": "llama3_8b", "layers": cfg.num_layers,
          "weights_gb": wbytes / 1e9, "init_s": init_s,
          "requests": batch, "prompt_len": prompt_len, "max_new": max_new,
          "decode_chunk": chunk, "tokens_each": sorted({len(results.get(r, [])) for r in rids}),
          "failed": eng.failed, "launches": launches, "launches_expected": want,
          "first_step_s": first_step_s, "ttft_warm_s": ttft,
          "decode_tok_s": toks / dt, "decode_ms_per_step": dt * 1e3 / max(steps, 1),
          "measured_tokens": toks, "prefill_logits_rel_err_vs_reference": rel,
          "rel_err_tol": 0.25, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "prefill_bench": {**prefill, "ok": prefill_ok, "launches": prefill_launches,
                            "launches_expected": prefill_want}})
    if not ok:
        raise AssertionError("serve phase failed its checks")


# The w8a8 products of Llama-3-8B: rows 1-8 (decode), 17 (the least
# torch._int_mm takes unpadded), 256 (serve's prefill) and 2048 (the prefill
# bench) against (in, out) of wq, wk|wv, w_gate|w_up, w_down and an INT8
# lm_head; timed at decode's 8 rows and the bench's 2048.
W8A8_MATMULS = dict(rows=(1, 8, 17, 256, 2048), timed_rows=(8, 2048),
                    shapes=((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                            (4096, 128256)))


def _w8a8_rows(g, rows, in_dim, dtype):
    """Random activation rows, a row of zeros (the 1e-8 clamp) and a last
    row whose max-abs is 127 (row scale 1.0) with the rest on halves, so
    x / row_scale lands on rounding ties."""
    import torch
    x = torch.randn((rows, in_dim), generator=g, device="cuda") * 2.0
    if rows > 1:
        x[0] = 0.0
    tie = (torch.arange(in_dim, device="cuda") % 9 - 4).float() + 0.5
    tie[0] = 127.0
    x[-1] = tie
    return x.to(dtype)


def _int_mm_checks():
    """w8a8's route on the card (quant/weights.py: quantize_rows, then
    torch._int_mm through _int_mm_padded) held bit for bit at every
    W8A8_MATMULS shape, f32 and bf16 x: the row quantization against the
    CPU's (exact division), the int32 product against the exact plain
    product (float64 sums), the output against the plain product scaled as
    qdense scales it. Then the times at the timed rows: qdense w8a8 and its
    parts, torch._int_mm on a row-major copy of the weight (the layout
    quantize_weight does not store), qdense w8a16 and the plain product."""
    import torch
    from quantizedmha_tpu_torch.quant import weights as tw
    g = torch.Generator(device="cuda").manual_seed(18)
    cases, failed, timed = 0, [], []
    for in_dim, out_dim in W8A8_MATMULS["shapes"]:
        w = tw.quantize_weight(torch.randn((in_dim, out_dim), generator=g, device="cuda") * 0.02)
        for rows in W8A8_MATMULS["rows"]:
            for dtype in (torch.float32, torch.bfloat16):
                x = _w8a8_rows(g, rows, in_dim, dtype)
                xq, row_scale = tw.quantize_rows(x)
                cpu_xq, cpu_scale = tw.quantize_rows(x.cpu())
                acc = tw._int_mm_padded(xq, w.values)
                ref = tw._w8a8_plain(xq, w.values)
                out = tw.qdense(x, w, mode="w8a8")
                want = (ref.float() * row_scale * w.scale).to(dtype)
                checks = {"payload": torch.equal(xq.cpu(), cpu_xq),
                          "row_scale": torch.equal(row_scale.cpu(), cpu_scale),
                          "int32": torch.equal(acc, ref), "out": torch.equal(out, want)}
                cases += 1
                if not all(checks.values()):
                    failed.append({"rows": rows, "in": in_dim, "out": out_dim,
                                   "x": str(dtype), **checks})
        w_row_major = w.values.contiguous()
        for rows in W8A8_MATMULS["timed_rows"]:
            x = _w8a8_rows(g, rows, in_dim, torch.bfloat16)
            xq, _ = tw.quantize_rows(x)
            padded = torch.nn.functional.pad(xq, (0, 0, 0, max(0, tw._INT_MM_MIN_ROWS - rows)))
            nbytes = rows * in_dim * 2 + in_dim * out_dim + out_dim * 4 + rows * out_dim * 2
            bms, by = bound(nbytes, {"int8": 2 * rows * in_dim * out_dim})
            timed.append({
                "rows": rows, "in": in_dim, "out": out_dim,
                "w8a8_ms": cuda_ms(lambda: tw.qdense(x, w, mode="w8a8"), iters=20),
                "quantize_rows_ms": cuda_ms(lambda: tw.quantize_rows(x), iters=20),
                "int_mm_ms": cuda_ms(lambda: tw._int_mm_padded(xq, w.values), iters=20),
                "int_mm_row_major_ms": cuda_ms(lambda: torch._int_mm(padded, w_row_major),
                                               iters=20),
                "w8a16_ms": cuda_ms(lambda: tw.qdense(x, w, mode="w8a16"), iters=20),
                "plain_ms": cuda_ms(lambda: tw._w8a8_plain(xq, w.values), iters=2, warmup=1),
                "bound_ms": bms, "bound_by": by})
        del w, w_row_major
        torch.cuda.empty_cache()
    return {"cases": cases, "failed": failed, "timed": timed}


class _CountCalls:
    """Counts the calls of a module attribute for the length of a `with`
    (the engine reaches it through the module, so the wrapper sees every
    call), and restores it after."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return self.orig(*a, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _logit_distance(a, b):
    """max |a - b| / std(b), the serve phases' logit distance."""
    return ((a - b).abs().max() / b.std()).item()


def _w8a8_logit_gates(cfg, params, toks):
    """The w8a8 model's last-token prefill logits, held (1) bit for bit to
    the same model with every int8 product taken by the exact plain product
    (float64 sums) in place of torch._int_mm, and (2) to the same model
    with the float reference attention within 0.25 std (the serve phase's
    budget for the INT8 attention) plus the golden's own activation
    quantization noise: its distance from the golden without it (the
    reference-attention model in w8a16, the same INT8 weights). w8a8's
    per-row rounding amplifies any small change of its input (on these
    random weights a 2^-7 nudge of the embeddings moves the logits by
    0.20-0.34 std at 1-32 layers, w8a16's by 0.06-0.11), so a golden with
    float attention sits that much off; the formula itself is held bit for
    bit by (1), by _int_mm_checks and by the CPU tests against JAX.
    Two faults planted at run time must each fail a gate: the row scale
    dropped from qdense's output, and the row scale divided by 127 through
    the reciprocal (PyTorch's CUDA division by a Python scalar) against the
    CPU's row quantization."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.quant import weights as tw
    from quantizedmha_tpu_torch.serving import llama_adapter

    def last_logits():
        return llama_adapter.prefill_at(cfg, params, toks, toks.shape[1] - 1)[0]

    logits = last_logits()
    exact_product = tw._int_mm_padded
    tw._int_mm_padded = tw._w8a8_plain
    try:
        plain = last_logits()
    finally:
        tw._int_mm_padded = exact_product
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    ref = llama.forward(ref_cfg, params, toks)[:, -1]
    ref16 = llama.forward(dataclasses.replace(ref_cfg, weight_quant_mode="w8a16"),
                          params, toks)[:, -1]
    w8a16 = llama_adapter.prefill_at(dataclasses.replace(cfg, weight_quant_mode="w8a16"),
                                     params, toks, toks.shape[1] - 1)[0]
    golden_noise = _logit_distance(ref, ref16)
    tol = 0.25 + golden_noise
    rel = _logit_distance(logits, ref)

    w8a8 = tw._w8a8
    tw._w8a8 = lambda x, w: (w8a8(x, w) / tw.quantize_rows(x)[1]).to(x.dtype)
    try:
        no_row_scale = _logit_distance(last_logits(), ref)
    finally:
        tw._w8a8 = w8a8
    x = _w8a8_rows(torch.Generator(device="cuda").manual_seed(7), 2048, 4096, torch.bfloat16)
    true_div = tw.true_div
    tw.true_div = lambda t, c: t / c
    try:
        reciprocal_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
            tw.quantize_rows(x), tw.quantize_rows(x.cpu())))
    finally:
        tw.true_div = true_div
    faults = {"no_row_scale": {"distance": no_row_scale, "caught": no_row_scale > tol},
              "reciprocal_row_scale": {"equal_cpu": reciprocal_equal,
                                       "caught": not reciprocal_equal}}
    res = {"bit_equal_exact_product": torch.equal(logits, plain),
           "rel_err_vs_reference": rel, "rel_err_tol": tol,
           "reference_w8a8_vs_w8a16": golden_noise,
           "rms_vs_reference": ((logits - ref).pow(2).mean().sqrt() / ref.std()).item(),
           "rel_err_vs_w8a16_same_attention": _logit_distance(logits, w8a16),
           "finite": bool(torch.isfinite(logits).all()), "planted_faults": faults}
    res["ok"] = (res["bit_equal_exact_product"] and res["finite"] and rel <= tol
                 and all(f["caught"] for f in faults.values()))
    return res


def phase_serve_w8a8(st):
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.harness import serving_bench
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.quant import weights as tw
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

    mm = _int_mm_checks()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attention_impl="flash_int8",
                              weight_quant_mode="w8a8")
    params = st.pop("serve_params", None)
    if params is None:  # serve did not run in this call: its params, from its seed
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tw.quantize_llama_params(llama.init_params(cfg, gen, device="cuda"), bits=8)
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    batch, prompt_len, max_new, chunk, page = 8, 256, 32, 8, 128
    mpps = -(-(prompt_len + max_new + chunk + 1) // page)
    ecfg = EngineConfig(num_pages=batch * mpps + 2, page_size=page, max_batch=batch,
                        max_pages_per_seq=mpps, prefill_buckets=(prompt_len,),
                        max_new_tokens=max_new, decode_chunk=chunk)
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist() for _ in range(batch)]
    eng.add_request(prompts[0][:100], max_new=chunk + 1)  # warm-up, outside the count
    eng.run()
    eng.finished.clear()

    for kern in (fa8.FLASH_INT8_P, fa8.FLASH_BF16_P, dec.PAGED_DECODE):
        kern.reset()
    admitted0 = eng.metrics.counter("requests_admitted")
    steps0 = eng.metrics.counter("decode_steps")
    with _CountCalls(tw, "_int_mm_padded") as int_mm:
        rids = [eng.add_request(p, max_new=max_new) for p in prompts]
        t0 = time.perf_counter()
        eng.step()  # 8 admissions (prefills) + the first fused chunk
        first_step_s = time.perf_counter() - t0
        toks0 = eng.metrics.counter("tokens_generated")
        sd0 = eng.metrics.counter("decode_steps")
        t0 = time.perf_counter()
        results = eng.run()
        dt = time.perf_counter() - t0
        toks = eng.metrics.counter("tokens_generated") - toks0
        steps = eng.metrics.counter("decode_steps") - sd0
        before = eng.metrics.counter("tokens_generated")
        t1 = time.perf_counter()
        eng.add_request(prompts[1], max_new=max_new)
        while eng.metrics.counter("tokens_generated") == before and (eng.queue or eng.active):
            eng.step()
        ttft = time.perf_counter() - t1
        eng.run()
    launches = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches,
                "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches,
                "paged_decode": dec.PAGED_DECODE.launches}
    admitted = eng.metrics.counter("requests_admitted") - admitted0
    decode_steps = eng.metrics.counter("decode_steps") - steps0
    want = {"flash_int8_fwd[int8_p]": cfg.num_layers * admitted, "flash_int8_fwd[bf16_p]": 0,
            "paged_decode": cfg.num_layers * decode_steps}
    # every forward runs the seven layer matmuls of each layer in w8a8
    int_mm_want = 7 * cfg.num_layers * (admitted + decode_steps)
    for name in ("flash_int8_fwd[int8_p]", "paged_decode"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    lens_ok = all(len(results.get(r, [])) == max_new for r in rids)
    drained = eng.alloc.free_pages == ecfg.num_pages - 1

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gates = _w8a8_logit_gates(cfg, params, torch.tensor([prompts[2]], dtype=torch.int32,
                                                        device="cuda"))
    ok = (not mm["failed"] and launches == want and int_mm.calls == int_mm_want and lens_ok
          and drained and not eng.failed and gates["ok"])

    torch.cuda.empty_cache()
    fa8.FLASH_INT8_P.reset()
    fa8.FLASH_BF16_P.reset()
    prefill = serving_bench.run_prefill_bench(cfg, params, prompt_len=PREFILL_BENCH_LEN)
    torch.cuda.synchronize()
    timing = serving_bench.PREFILL_TIMING
    prefill_launches = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches,
                        "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches}
    prefill_want = {"flash_int8_fwd[int8_p]": cfg.num_layers * (
                        timing["warmup"] + timing["runs"] * timing["repeats"]),
                    "flash_int8_fwd[bf16_p]": 0}
    st["launches"]["flash_int8_fwd[int8_p]"] += prefill_launches["flash_int8_fwd[int8_p]"]
    prefill_ok = (prefill_launches == prefill_want and prefill["prefill_ms"] > 0
                  and 0 < prefill["prefill_pct_mxu_sol"] <= 100)
    ok = ok and prefill_ok
    if st.get("profile"):
        bench_toks = torch.as_tensor(
            np.random.default_rng(0).integers(1, cfg.vocab_size, (1, PREFILL_BENCH_LEN)),
            dtype=torch.int32, device="cuda")
        emit({"phase": "serve_w8a8_prefill_profile", "prefill_len": PREFILL_BENCH_LEN,
              **_profile_prefill(lambda: llama_adapter.prefill_at(
                  cfg, params, bench_toks, PREFILL_BENCH_LEN - 1))})
    emit({"phase": "serve_w8a8", "ok": ok, "model": "llama3_8b", "layers": cfg.num_layers,
          "weight_quant_mode": cfg.weight_quant_mode, "int_mm": mm,
          "requests": batch, "prompt_len": prompt_len, "max_new": max_new,
          "decode_chunk": chunk, "tokens_each": sorted({len(results.get(r, [])) for r in rids}),
          "failed": eng.failed, "pools_drained": drained, "launches": launches,
          "launches_expected": want, "int_mm_calls": int_mm.calls,
          "int_mm_calls_expected": int_mm_want, "first_step_s": first_step_s,
          "ttft_warm_s": ttft, "decode_tok_s": toks / dt,
          "decode_ms_per_step": dt * 1e3 / max(steps, 1), "measured_tokens": toks,
          "logit_gates": gates, "peak_mem_gb": peak_gb,
          "prefill_bench": {**prefill, "ok": prefill_ok, "launches": prefill_launches,
                            "launches_expected": prefill_want,
                            "w8a16_prefill_ms_same_run": st.get("serve_prefill_ms")},
          "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("serve_w8a8 phase failed its checks")


SERVE_FLASH = dict(bucketed=(256, 700, 1500, 2000), long=(5000, 7900), shared=4096,
                   hit_suffixes=(300, 1000), max_new=32, chunk=8, page=128, num_pages=256,
                   decode_new=72)


def _first_token_at(eng, rid):
    """True once request rid has its first sampled token."""
    return rid in eng.finished or any(s.seq_id == rid for s in eng.active)


def phase_serve_flash(st):
    """Llama-3-8B as configured (attention_impl="flash", bf16 weights, all
    32 layers) through the engine with the JAX default buckets, prefix
    caching and interleaved prefill: four bucketed prompts, two long ones
    prefilled in chunks between the others' decode steps, then two prompts
    that share the longest one's first 4096 tokens (prefix hits)."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    from quantizedmha_tpu_torch.serving.kv_cache import PageAllocator

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sf = SERVE_FLASH
    cfg = llama.LlamaConfig.llama3_8b()
    L = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = EngineConfig(num_pages=sf["num_pages"], page_size=sf["page"], max_batch=8,
                        max_pages_per_seq=64, prefill_buckets=(128, 256, 512, 1024, 2048),
                        max_new_tokens=sf["max_new"], decode_chunk=sf["chunk"],
                        prefix_cache=True, interleaved_prefill=True)
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size
    prompts = [rng.integers(1, vocab, n).tolist() for n in sf["bucketed"] + sf["long"]]
    longest = prompts[-1]
    hits = [longest[:sf["shared"]] + rng.integers(1, vocab, n).tolist()
            for n in sf["hit_suffixes"]]
    # Warm-up outside the measured run: a bucketed prompt and a two-chunk
    # one (first cuBLAS and kernel use), on tokens no later prompt shares.
    for n in (100, 2100):
        eng.add_request(rng.integers(1, vocab, n).tolist(), max_new=sf["chunk"] + 1)
    eng.run()
    eng.finished.clear()

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "paged_prefill": pp.PAGED_PREFILL, "paged_decode": dec.PAGED_DECODE,
               "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P}
    counters = ("decode_steps", "tokens_generated", "prefix_cache_hits",
                "prefix_tokens_reused", "prefill_chunks_interleaved", "requests_admitted")
    base = {c: eng.metrics.counter(c) for c in counters}
    for kern in kernels.values():
        kern.reset()
    t_add, ttft = {}, {}
    t_start = time.perf_counter()
    rids = []
    for p in prompts:
        rids.append(eng.add_request(p, max_new=sf["max_new"]))
        t_add[rids[-1]] = t_start
    long_rid, hit_rids = rids[-1], []
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        torch.cuda.synchronize()
        te = time.perf_counter()
        for rid in t_add:
            if rid not in ttft and _first_token_at(eng, rid):
                ttft[rid] = te - t_add[rid]
        if not hit_rids and any(s.seq_id == long_rid for s in eng.active):
            # The 7900-token prompt is prefilled and decoding: its pages are
            # registered, so these two share its first 32 pages.
            for p in hits:
                hit_rids.append(eng.add_request(p, max_new=sf["max_new"]))
                t_add[hit_rids[-1]] = time.perf_counter()
    run_s = time.perf_counter() - t_start
    # Decode at a full batch: eight fresh prompts of the largest bucketed
    # length, admitted in one step; every later step that decodes all
    # eight for a whole chunk (no admission, no sequence finished) is timed.
    batch_prompts = [rng.integers(1, vocab, sf["bucketed"][-1]).tolist() for _ in range(8)]
    batch_rids = [eng.add_request(p, max_new=sf["decode_new"]) for p in batch_prompts]
    decode_wall = []
    while eng.queue or eng.active or eng.prefilling:
        before = {c: eng.metrics.counter(c) for c in ("requests_admitted", "decode_steps",
                                                      "tokens_generated")}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        d = {c: eng.metrics.counter(c) - before[c] for c in before}
        if (d["requests_admitted"] == 0 and d["decode_steps"] == sf["chunk"]
                and d["tokens_generated"] == 8 * sf["chunk"]):
            decode_wall.append(dt)
    launches = {name: kern.launches for name, kern in kernels.items()}
    delta = {c: eng.metrics.counter(c) - base[c] for c in counters}
    results = eng.finished
    n_chunks = (sum(-(-n // 2048) for n in sf["long"])
                + sum(1 for _ in sf["hit_suffixes"]))  # each suffix fits one bucket
    n_bucketed = len(sf["bucketed"]) + len(batch_rids)
    want = {"flash_fwd[bf16]": L * n_bucketed, "flash_fwd[f32]": 0,
            "paged_prefill": L * n_chunks, "paged_decode": L * int(delta["decode_steps"]),
            "flash_int8_fwd[int8_p]": 0, "flash_int8_fwd[bf16_p]": 0}
    for name in ("flash_fwd[bf16]", "paged_prefill", "paged_decode"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    all_rids = rids + hit_rids
    lens_ok = (len(hit_rids) == 2
               and all(len(results.get(r, [])) == sf["max_new"] for r in all_rids)
               and all(len(results.get(r, [])) == sf["decode_new"] for r in batch_rids))
    in_vocab = all(0 <= t < vocab for r in all_rids + batch_rids for t in results.get(r, []))
    counts_ok = (launches == want and delta["prefix_cache_hits"] == 2
                 and delta["prefix_tokens_reused"] == 2 * sf["shared"]
                 and delta["prefill_chunks_interleaved"] > 0 and len(decode_wall) >= 4)

    # Right by the repo's own means: last-token logits against the float
    # attention golden (attention_impl="reference") on the same tokens, for
    # the 2000-token bucketed prefill and the 5000-token prompt prefilled in
    # chunks through a fresh paged cache. Each path runs twice; the second
    # run is timed (prefill tok/s).
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    checks = {}
    n_b = sf["bucketed"][-1]
    toks = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
    toks[0, :n_b] = torch.tensor(prompts[len(sf["bucketed"]) - 1], device="cuda")
    def bucketed():
        return llama_adapter.prefill_at(cfg, params, toks, n_b - 1)[0]
    for _ in range(2):
        torch.cuda.synchronize()
        tb = time.perf_counter()
        logits = bucketed()
        torch.cuda.synchronize()
        bucket_s = time.perf_counter() - tb
    ref = llama.forward(ref_cfg, params, toks[:, :n_b])[:, -1]
    checks["bucketed_2000"] = ((logits - ref).abs().max() / ref.std()).item()
    del ref
    n_c = sf["long"][0]
    chunk = 2048
    slots = -(-n_c // chunk) * chunk // sf["page"]
    cache = llama_adapter.make_cache(cfg, slots + 1, sf["page"], device="cuda")
    alloc = PageAllocator(slots + 1, sf["page"], scrap_page=0)
    alloc.admit(0, n_c)
    table = torch.tensor(alloc.block_table_array([0], slots)[0], device="cuda")
    ctoks = torch.tensor(prompts[len(sf["bucketed"])], dtype=torch.int32, device="cuda")

    def chunked():
        for start in range(0, n_c, chunk):
            part = torch.zeros((1, chunk), dtype=torch.int32, device="cuda")
            n_part = min(chunk, n_c - start)
            part[0, :n_part] = ctoks[start:start + n_part]
            out, _ = llama_adapter.prefill_chunk(cfg, params, cache, part, start, table,
                                                 n_part - 1, page_size=sf["page"])
        return out
    for _ in range(2):
        torch.cuda.synchronize()
        tc = time.perf_counter()
        clog = chunked()
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - tc
    if st.get("profile"):
        emit({"phase": "serve_flash_profile",
              "bucketed_2000": _profile_prefill(bucketed),
              "chunked_5000": _profile_prefill(chunked)})
    del cache
    ref = llama.forward(ref_cfg, params, ctoks[None])[:, -1]
    checks["chunked_5000"] = ((clog - ref).abs().max() / ref.std()).item()
    finite = bool(torch.isfinite(logits).all().item() and torch.isfinite(clog).all().item())
    del ref
    torch.cuda.empty_cache()

    dec_s = sum(decode_wall)
    dec_steps = sf["chunk"] * len(decode_wall)
    ok = (lens_ok and in_vocab and counts_ok and not eng.failed and finite
          and max(checks.values()) <= 0.25)
    emit({"phase": "serve_flash", "ok": ok, "model": "llama3_8b", "attention_impl": "flash",
          "layers": L, "weights": "bf16", "init_s": init_s,
          "prompts": list(sf["bucketed"] + sf["long"]),
          "prefix_hits": [sf["shared"] + n for n in sf["hit_suffixes"]],
          "max_new": sf["max_new"], "decode_chunk": sf["chunk"],
          "tokens_each": sorted({len(results.get(r, [])) for r in all_rids}),
          "failed": eng.failed, "launches": launches, "launches_expected": want,
          "counters": delta, "run_s": run_s,
          "ttft_cold_long_s": [ttft.get(r) for r in rids[len(sf["bucketed"]):]],
          "ttft_bucketed_s": [ttft.get(r) for r in rids[:len(sf["bucketed"])]],
          "ttft_prefix_hit_s": [ttft.get(r) for r in hit_rids],
          "prefill_tok_s_bucketed": n_b / bucket_s, "prefill_2000_s": bucket_s,
          "prefill_tok_s_chunked": n_c / chunked_s, "prefill_chunked_5000_s": chunked_s,
          "decode_batch": 8, "decode_prompt_len": sf["bucketed"][-1],
          "decode_new": sf["decode_new"], "decode_engine_steps_timed": len(decode_wall),
          "decode_tok_s_batch8": 8 * dec_steps / dec_s if dec_s else None,
          "decode_ms_per_step_batch8": dec_s * 1e3 / dec_steps if dec_steps else None,
          "logits_rel_err_vs_reference": checks, "rel_err_tol": 0.25,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not ok:
        raise AssertionError("serve_flash phase failed its checks")


# serve_hybrid: LlamaConfig.gemma2_9b() through hybrid_kv pools, page 128.
# Traffic: two bucketed prompts, a 6000-token one (three chunks of 2048,
# interleaved; its decode starts past the 4096 window), 64 new tokens each,
# then a prompt sharing the long one's first 46 pages (5888 tokens; the
# sliding pool can share only the pages its window still holds, and the
# owner's first trim freed pages 0-13, so a shorter shared prefix would
# find no sliding row) plus 300 tokens of its own.
#   Pages a pool holds at the peak without trims (A, B, C and D all active):
#   3 (300 + 64 tokens) + 15 (1800 + 64) + 48 (6000 + 64) + 3 (D's pages past
#   the 46 it shares) + the scrap page = 70. The full pool: 80 (70 and
#   slack). The sliding pool: 68, two short of 70; its transient peak is C's
#   admission beside A and B, 3 + 15 + 47 + 1 = 66, and after C's trims
#   each sequence holds at most ceil((4096 + 128) / 128) + 1 = 33 + 1 = 34
#   sliding pages.
SERVE_HYBRID = dict(bucketed=(300, 1800), long=6000, shared_pages=46, hit_suffix=300,
                    max_new=64, chunk=8, page=128, pages={"full": 80, "w4096": 68},
                    max_pages=64, logit_tol=0.25)


def _hybrid_traffic(eng, prompts, hit, sh, on_step=None):
    """Drive serve_hybrid's traffic through `eng`: the prompts at once, the
    hit (unless None) once the last prompt is decoding. Returns (request
    ids, the hit's id, {rid: TTFT s}, decode-only step walls and
    batches)."""
    import torch
    t_add, ttft, rids = {}, {}, []
    t0 = time.perf_counter()
    for p in prompts:
        rids.append(eng.add_request(p, max_new=sh["max_new"]))
        t_add[rids[-1]] = t0
    hit_rid, walls = None, []
    while eng.queue or eng.active or eng.prefilling:
        before = {c: eng.metrics.counter(c) for c in
                  ("requests_admitted", "decode_steps", "prefill_chunks_interleaved")}
        batch = len(eng.active)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        te = time.perf_counter()
        d = {c: eng.metrics.counter(c) - before[c] for c in before}
        if (d["requests_admitted"] == 0 and d["prefill_chunks_interleaved"] == 0
                and d["decode_steps"] == sh["chunk"]):
            walls.append((te - ts, batch))
        for rid in t_add:
            if rid not in ttft and _first_token_at(eng, rid):
                ttft[rid] = te - t_add[rid]
        if on_step is not None:
            on_step(eng, rids, hit_rid)
        if (hit is not None and hit_rid is None
                and any(s.seq_id == rids[-1] for s in eng.active)):
            hit_rid = eng.add_request(hit, max_new=sh["max_new"])
            t_add[hit_rid] = time.perf_counter()
    return rids, hit_rid, ttft, walls


def phase_serve_hybrid(st):
    """Gemma-2-9B as configured (42 layers, head_dim 256, a 4096 window on
    even layers, softcaps 50 and 30, attention_impl="flash", random bf16
    weights) through the engine with hybrid_kv: a page pool for the full
    layers and one for the sliding layers, prefix caching and interleaved
    prefill. Rows 3, 5 and 10 run at head_dim 256. The same traffic then
    runs through a shared-pool engine (hybrid_kv=False) on the card
    (_gemma2_pools_run)."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.serving import llama_adapter

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
    sh = SERVE_HYBRID
    cfg = llama.LlamaConfig.gemma2_9b()
    L, P = cfg.num_layers, sh["page"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    run = _gemma2_pools_run(st, cfg, params, sh, mixed=False, launches_key="launches_d256")
    groups = llama_adapter.window_groups(cfg)

    # Right by the repo's own means: the long prompt's last logits, prefilled
    # in chunks through fresh hybrid pools (each group's table another
    # permutation of its pool), against the float attention golden.
    caches = llama_adapter.make_cache_hybrid(cfg, {k: 49 for k in groups}, P, device="cuda")
    n = sh["long"]
    slots = -(-n // 2048) * 2048 // P
    tables = {k: torch.randperm(48, generator=torch.Generator().manual_seed(i))[:slots]
              .add(1).to(torch.int32).cuda() for i, k in enumerate(sorted(groups))}
    toks = torch.tensor(run["requests"][len(sh["bucketed"])][1], dtype=torch.int32,
                        device="cuda")
    for start in range(0, n, 2048):
        part = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
        m = min(2048, n - start)
        part[0, :m] = toks[start:start + m]
        logits, caches = llama_adapter.prefill_chunk(cfg, params, caches, part, start, tables,
                                                     m - 1, page_size=P)
    del caches
    golden = llama_adapter.prefill_at(dataclasses.replace(cfg, attention_impl="reference"),
                                      params, toks[None], n - 1)[0]
    rel = ((logits.float() - golden.float()).abs().max() / golden.float().std()).item()
    finite = bool(torch.isfinite(logits).all().item())
    del golden
    torch.cuda.empty_cache()

    ok = run["ok"] and finite and rel <= sh["logit_tol"]
    emit({"phase": "serve_hybrid", "ok": ok, "model": "gemma2_9b", "layers": L,
          "head_dim": cfg.hd, "attention_impl": cfg.attention_impl, "weights": "bf16",
          "init_s": init_s, **run["report"],
          "logits_rel_err_vs_reference": rel, "rel_err_tol": sh["logit_tol"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "mem_at_start_gb": mem_at_start})
    if not ok:
        raise AssertionError("serve_hybrid phase failed its checks")


# serve_hf: a Gemma-2-9B-width checkpoint in HF's layout, cut to 4 layers
# (sliding, full, sliding, full), bf16, tied embeddings, three files and an
# index. Pools: the full layers hold every page of the four prompts (3 + 10
# + 16 + 41 pages, a decode chunk's reserve each, the scrap page); the
# sliding layers at most 34 a sequence (the window's 32 pages, the page
# being written and one more) for the long one and every page of the three
# short ones.
SERVE_HF = dict(layers=4, shards=3, seed=21, bucketed=(300, 1200, 2000), long=5200, max_new=16,
                chunk=8, page=128, pages={"full": 80, "w4096": 68}, max_pages=64,
                logit_tol=0.25)


def _gemma2_hf_names(cfg):
    """[(HF name, HF shape, kind)] of a Gemma-2 checkpoint (tied: no
    lm_head.weight): kind "norm", "embed", "q" / "k" (rows in HF's
    rotate-half order) or "w"."""
    h, hd, inter = cfg.hidden_size, cfg.hd, cfg.intermediate_size
    out = [("model.embed_tokens.weight", (cfg.vocab_size, h), "embed"),
           ("model.norm.weight", (h,), "norm")]
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        out += [(pre + n + ".weight", (h,), "norm")
                for n in ("input_layernorm", "post_attention_layernorm",
                          "pre_feedforward_layernorm", "post_feedforward_layernorm")]
        out += [(pre + "self_attn.q_proj.weight", (cfg.num_heads * hd, h), "q"),
                (pre + "self_attn.k_proj.weight", (cfg.num_kv_heads * hd, h), "k"),
                (pre + "self_attn.v_proj.weight", (cfg.num_kv_heads * hd, h), "w"),
                (pre + "self_attn.o_proj.weight", (h, cfg.num_heads * hd), "w"),
                (pre + "mlp.gate_proj.weight", (inter, h), "w"),
                (pre + "mlp.up_proj.weight", (inter, h), "w"),
                (pre + "mlp.down_proj.weight", (h, inter), "w")]
    return out


def _gemma2_hf_tensor(name, shape, kind, seed, hidden, dev="cuda"):
    """One tensor of the checkpoint in bf16, on the card, from a generator
    seeded by (seed, name), rows in the port's order (q / k unpermuted):
    norms ~ N(0, 0.1) (Gemma scales by 1 + w), the embedding ~ N(0,
    hidden^-1) (times sqrt(hidden) in the model), a projection [out, in] ~
    N(0, in^-1)."""
    import zlib

    import torch
    g = torch.Generator(device=dev).manual_seed(seed * 2**32 + zlib.crc32(name.encode()))
    std = 0.1 if kind == "norm" else hidden**-0.5 if kind == "embed" else shape[-1]**-0.5
    return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)


def _rotate_half_rows(w, hd):
    """HF's q/k row order from the port's: each head's rows (hd/2, 2) ->
    (2, hd/2), the permutation HF's convert script applies."""
    out, inp = w.shape
    return w.reshape(out // hd, hd // 2, 2, inp).transpose(1, 2).reshape(out, inp)


def _write_gemma2_hf(path, cfg, seed, shards, dev="cuda"):
    """A Gemma-2 checkpoint directory in HF's layout (config.json with the
    keys config_from_hf reads, the preset's values; tensors in bf16 over
    `shards` files and model.safetensors.index.json), written with the
    port's safetensors writer one file at a time. Returns the bytes
    written."""
    import torch
    from quantizedmha_tpu_torch.utils.safetensors_io import save_file
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dict(
        architectures=["Gemma2ForCausalLM"], model_type="gemma2", torch_dtype="bfloat16",
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
        sliding_window=next(w for w in cfg.layer_windows if w is not None),
        query_pre_attn_scalar=cfg.query_pre_attn_scalar,
        attn_logit_softcapping=cfg.logit_softcap,
        final_logit_softcapping=cfg.final_logit_softcap,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True)))
    names = sorted(_gemma2_hf_names(cfg))
    per = -(-len(names) // shards)
    weight_map, nbytes = {}, 0
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {}
        for name, shape, kind in names[s * per:(s + 1) * per]:
            t = _gemma2_hf_tensor(name, shape, kind, seed, cfg.hidden_size, dev)
            if kind in ("q", "k"):
                t = _rotate_half_rows(t, cfg.hd)
            part[name] = t.cpu()
            nbytes += t.numel() * 2
            weight_map[name] = fname
        save_file(part, path / fname, metadata={"format": "pt"})
        del part
        _empty_cache(dev)
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": nbytes}, "weight_map": weight_map}))
    return nbytes


def _loaded_as_written(cfg, params, seed, dev="cuda"):
    """Gate (b): every INT8 projection's values and scales bit-equal to
    quantize_weight of the tensor as written (unpermuted, transposed), and
    every norm and the embedding (and the tied lm_head) bit-equal to the
    written bf16. Returns the names that differ."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import quantize_weight
    ours = {"self_attn.q_proj": "wq", "self_attn.k_proj": "wk", "self_attn.v_proj": "wv",
            "self_attn.o_proj": "wo", "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
            "mlp.down_proj": "w_down", "input_layernorm": "attn_norm",
            "post_attention_layernorm": "post_attn_norm",
            "pre_feedforward_layernorm": "mlp_norm",
            "post_feedforward_layernorm": "post_mlp_norm"}
    bad = []
    for name, shape, kind in _gemma2_hf_names(cfg):
        t = _gemma2_hf_tensor(name, shape, kind, seed, cfg.hidden_size, dev)
        if name == "model.embed_tokens.weight":
            same = (torch.equal(params["embed"], t)
                    and torch.equal(params["lm_head"], t.T))
        elif name == "model.norm.weight":
            same = torch.equal(params["final_norm"], t)
        else:
            i, rest = name[len("model.layers."):].split(".", 1)
            leaf = params["layers"][ours[rest.rsplit(".", 1)[0]]]
            if kind == "norm":
                same = torch.equal(leaf[int(i)], t)
            else:
                want, got = quantize_weight(t.T.contiguous()), leaf.layer(int(i))
                same = torch.equal(got.values, want.values) and torch.equal(got.scale, want.scale)
        if not same:
            bad.append(name)
        del t
    return bad


class _EngineLogits:
    """While active, the last-token logits of every bucketed prefill
    (prefill_at) and every prefill chunk (prefill_chunk) the engine runs,
    keyed by the prompt length they end (a chunk's start + its last index
    + 1): the engine's own logits for each prompt."""

    def __enter__(self):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        self.saved = {n: getattr(la, n) for n in ("prefill_at", "prefill_chunk")}
        self.logits = {}

        def at(cfg, params, tokens, last_index, **kw):
            out = self.saved["prefill_at"](cfg, params, tokens, last_index, **kw)
            self.logits[last_index + 1] = out[0].detach().float().clone()
            return out

        def chunk(cfg, params, cache, tokens, chunk_start, table, last_index, **kw):
            out = self.saved["prefill_chunk"](cfg, params, cache, tokens, chunk_start, table,
                                              last_index, **kw)
            self.logits[chunk_start + last_index + 1] = out[0].detach().float().clone()
            return out
        la.prefill_at, la.prefill_chunk = at, chunk
        return self

    def __exit__(self, *exc):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        for n, fn in self.saved.items():
            setattr(la, n, fn)


def phase_serve_hf(st):
    """A Gemma-2-9B-width checkpoint written in HF's layout (SERVE_HF),
    loaded by config_from_hf and load_llama(quantize=True) (w8a16) and
    served with attention_impl="flash_int8" through the engine with
    hybrid_kv: row 1 (int8 P) at d=256 runs every bucketed prefill, row 10
    the long prompt's chunks, row 3 the decode. Gates (a)-(f) of the
    module docstring."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import hf_loader, llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

    t_phase = time.perf_counter()
    dev = st.get("device", "cuda")
    _empty_cache(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sh = SERVE_HF
    L, P = sh["layers"], sh["page"]
    preset = llama.LlamaConfig.gemma2_9b()
    cut = dataclasses.replace(preset, num_layers=L, window_pattern=preset.window_pattern[:L])
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="serve_hf_"))
    try:
        t0 = time.perf_counter()
        written = _write_gemma2_hf(tmp / "gemma2", cut, sh["seed"], sh["shards"], dev)
        write_s = time.perf_counter() - t0
        # (a) the config.
        cfg = hf_loader.config_from_hf(tmp / "gemma2")
        differ = [f.name for f in dataclasses.fields(cfg)
                  if getattr(cfg, f.name) != getattr(cut, f.name)]
        config_ok = not differ and cfg.num_layers == L
        # (f) head_dim 96 refused on the card by the head-dim rule.
        bad_dir = tmp / "head_dim_96"
        bad_dir.mkdir()
        (bad_dir / "config.json").write_text(json.dumps(dict(
            json.loads((tmp / "gemma2" / "config.json").read_text()), head_dim=96)))
        try:
            hf_loader.load_llama(bad_dir, quantize=True, device="cuda")
            refusal = None
        except NotImplementedError as e:
            refusal = str(e)
        refused = refusal is not None and "head-dim rule" in refusal
        # Read and quantize.
        _sync(dev)
        t0 = time.perf_counter()
        params = hf_loader.load_llama(tmp / "gemma2", cfg, quantize=True, device=dev)
        _sync(dev)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # (b) the leaves as written.
    not_as_written = _loaded_as_written(cut, params, sh["seed"], dev)
    cfg = dataclasses.replace(cfg, attention_impl="flash_int8")

    eng = Engine(cfg, params, EngineConfig(
        num_pages=sh["pages"]["full"], page_size=P, max_batch=4,
        max_pages_per_seq=sh["max_pages"], prefill_buckets=(128, 256, 512, 1024, 2048),
        max_new_tokens=sh["max_new"], decode_chunk=sh["chunk"], interleaved_prefill=True,
        hybrid_kv=True, hybrid_pages=dict(sh["pages"])), device=dev)
    assert eng.hybrid and set(eng.allocs) == {"full", "w4096"}
    rng = np.random.default_rng(sh["seed"])
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in sh["bucketed"] + (sh["long"],)]
    kernels = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P, "paged_prefill": pp.PAGED_PREFILL,
               "paged_decode": dec.PAGED_DECODE}
    # Warm-up (first cuBLAS and kernel use), its launches counted apart.
    for kern in kernels.values():
        kern.reset()
    eng.add_request(rng.integers(1, cfg.vocab_size, 100).tolist(), max_new=sh["chunk"] + 1)
    eng.run()
    eng.finished.clear()
    warmup = {name: kern.launches for name, kern in kernels.items()}

    seen = {"long_live": {"full": 0, "w4096": 0}}

    def watch(e, rids, _hit):
        for k, a in e.allocs.items():
            if rids[-1] in a.tables:
                seen["long_live"][k] = max(seen["long_live"][k],
                                           sum(p is not None for p in a.tables[rids[-1]]))
    runs = []
    for attempt in range(2):  # (e) the same traffic twice, the same streams
        for kern in kernels.values():
            kern.reset()
        steps0 = eng.metrics.counter("decode_steps")
        _sync(dev)
        t_run = time.perf_counter()
        with _EngineLogits() as cap:
            rids, _, ttft, walls = _hybrid_traffic(eng, prompts, None, sh, on_step=watch)
        run_s = time.perf_counter() - t_run
        launches = {name: kern.launches for name, kern in kernels.items()}
        steps = eng.metrics.counter("decode_steps") - steps0
        runs.append(dict(streams=[eng.finished.get(r) for r in rids], launches=launches,
                         steps=steps, ttft=[ttft.get(r) for r in rids], walls=walls,
                         run_s=run_s, logits=cap.logits))
        eng.finished.clear()
        if attempt == 0:
            for name, n in launches.items():
                st["launches"][name] = st["launches"].get(name, 0) + n
                st["launches_d256"][name] = st["launches_d256"].get(name, 0) + n
    drained = all(not a.tables and a.free_pages == a.num_pages - 1 for a in eng.allocs.values())
    first = runs[0]
    n_chunks = -(-sh["long"] // 2048)
    want = {"flash_int8_fwd[int8_p]": L * len(sh["bucketed"]), "paged_prefill": L * n_chunks,
            "paged_decode": L * int(first["steps"])}
    same_streams = runs[1]["streams"] == first["streams"]
    lens_ok = all(s is not None and len(s) == sh["max_new"] for s in first["streams"])
    peak_gb = _peak_gb(dev)
    del eng
    _empty_cache(dev)

    # (c) each prompt's last logits from the engine against the golden: the
    # same loaded params with the float reference attention
    # (mha_masked_reference, K/V unquantized), the prompt unpadded.
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    dist, finite = {}, True
    for p in prompts:
        got = first["logits"].get(len(p))
        golden = llama_adapter.prefill_at(ref_cfg, params, torch.tensor(
            [p], dtype=torch.int32, device=dev), len(p) - 1)[0].float()
        dist[len(p)] = None if got is None else _logit_distance(got, golden)
        finite &= got is not None and bool(torch.isfinite(got).all().item())
        del golden
    logits_ok = finite and all(d is not None and d <= sh["logit_tol"] for d in dist.values())
    groups = llama_adapter.window_groups(cfg)
    page_bytes = 2 * cfg.num_kv_heads * (P * cfg.hd + 4)
    kv_long = sum(seen["long_live"][k] * len(groups[k]) * page_bytes for k in groups)
    dec_s = sum(w for w, _ in first["walls"])
    dec_steps = sh["chunk"] * len(first["walls"])
    ok = (config_ok and not not_as_written and logits_ok and first["launches"] == want
          and same_streams and refused and lens_ok and drained)
    emit({"phase": "serve_hf", "ok": ok, "model": "gemma2_9b width, HF checkpoint",
          "layers": L, "head_dim": cfg.hd, "weights": "w8a16 (INT8 on load)",
          "attention_impl": cfg.attention_impl, "checkpoint_bytes": written,
          "checkpoint_files": sh["shards"], "config_equal_preset": config_ok,
          "config_fields_differing": differ, "not_as_written": not_as_written,
          "head_dim_96_refused": refused, "refusal": refusal,
          "prompts": list(sh["bucketed"]) + [sh["long"]], "max_new": sh["max_new"],
          "launches": first["launches"], "launches_expected": want,
          "launches_second_run": runs[1]["launches"], "warmup_launches": warmup,
          "streams_same_twice": same_streams, "pools_drained": drained,
          "logit_distance_vs_reference_golden": dist, "logit_tol": sh["logit_tol"],
          "write_s": write_s, "read_quantize_s": load_s, "serve_s": first["run_s"],
          "ttft_s": first["ttft"], "decode_ms_per_step":
              dec_s * 1e3 / dec_steps if dec_steps else None,
          "decode_engine_steps_timed": len(first["walls"]),
          "kv_bytes_long": kv_long, "long_live_pages": seen["long_live"],
          "peak_mem_gb": peak_gb, "phase_s": time.perf_counter() - t_phase,
          "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("serve_hf phase failed its checks")


SERVE_MIXED = dict(bucketed=(240, 1000, 2000), long=(5000, 7900), max_new=32, chunk=8,
                   page=128, decode_new=72, logit_tol=0.25,
                   mixed={"boundary_tokens": 256, "int8_pages": 32, "int4_pages": 512,
                          "subs": 4})


def _cache_page_bytes(cfg, page, subs=None):
    """Bytes of one page of a layer-stacked cache: K and V of every layer
    and kv head, payload and scales (INT8, or nibble-packed INT4 with subs
    scales)."""
    per_head = page * cfg.hd + 4 if subs is None else page * cfg.hd // 2 + 4 * subs
    return cfg.num_layers * 2 * cfg.num_kv_heads * per_head


def _kv_quantized_logits(cfg, params, toks, *, boundary, page, subs, n_written=None, rows=None,
                         float_prompt=False):
    """Last-token logits (the last `rows` tokens', [B, rows, vocab], when
    given) of the model with float attention over K/V passed
    through the mixed cache's quantization and back: each layer's K and V
    (after RoPE, in the model's dtype), page by page, INT8 with one scale a
    head below `boundary` and INT4 with one scale a head and sub-tile past
    it, dequantized to f32. A sliding layer (a window pattern's, in hybrid
    pools whose full group alone is mixed) keeps every page INT8 and
    attends within its window. The first n_written tokens (default all)
    are written as a prefill writes them, a scale fitted over each page's
    (sub-tile's) tokens; the rest as decode appends them, a page (sub-tile)
    that starts there fitted by its first token and every later token
    quantized with the scale it finds and clamped. float_prompt: the first
    n_written rows attend to their own float K/V, as a bucketed prefill's
    flash attention does before it writes the pages (a chunked or
    prefix-cached prefill reads them back through the cache, the default).
    The golden of the mixed cache's numerics, without its kernels, its
    paging or its chunking."""
    import functools
    import torch
    from quantizedmha_tpu_torch.models.llama import (
        embed_tokens, final_logits, layer_params, qkv_triple, rms_norm)
    from quantizedmha_tpu_torch.ops.quantize import true_div
    from quantizedmha_tpu_torch.quant.weights import qdense
    from quantizedmha_tpu_torch.reference.mha import apply_rope, mha_masked_reference
    from quantizedmha_tpu_torch.serving.llama_adapter import _attn_residual, _mlp_residual
    b, n = toks.shape
    n_written = n if n_written is None else n_written
    n_pad = -(-n // page) * page
    nb = boundary // page

    def through_cache(x, nb):  # [Hkv, n, D] -> the dequantized cache contents, f32
        h, _, d = x.shape
        xp = torch.zeros((h, n_pad, d), dtype=torch.float32, device=x.device)
        xp[:, :n] = x.float()
        out = torch.empty_like(xp)
        for start, stop, unit, qmax in ((0, min(nb * page, n_pad), page, 127.0),
                                        (nb * page, n_pad, page // subs, 7.0)):
            if stop <= start:
                continue
            seg = xp[:, start:stop].reshape(h, -1, unit, d)      # [Hkv, units, unit, D]
            pos = start + torch.arange(stop - start, device=x.device).reshape(-1, unit)
            amax = seg.abs().amax(-1)                             # [Hkv, units, unit]
            fitted = torch.where(pos[:, 0] < n_written, (amax * (pos < n_written)).amax(-1),
                                 amax[..., 0])
            scale = true_div(torch.clamp(fitted, min=1e-8), qmax)[..., None, None]
            q = torch.clamp(torch.round(seg / scale), -qmax, qmax)
            out[:, start:stop] = (q * scale).reshape(h, stop - start, d)
        return out[:, :n]
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    x = embed_tokens(cfg, params, toks)
    hd = cfg.hd
    for i, window in enumerate(cfg.layer_windows):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = apply_rope(q.reshape(b, n, cfg.num_heads, hd).transpose(1, 2), cfg.rope_theta)
        k = apply_rope(k.reshape(b, n, cfg.num_kv_heads, hd).transpose(1, 2), cfg.rope_theta)
        v = v.reshape(b, n, cfg.num_kv_heads, hd).transpose(1, 2)
        nb_layer = nb if window is None else n_pad // page
        masks = dict(sm_scale=cfg.sm_scale, causal=True, window=window,
                     softcap=cfg.logit_softcap)
        kc, vc = (through_cache(x[0], nb_layer)[None] for x in (k, v))
        if float_prompt:
            m = n_written
            o = torch.cat([mha_masked_reference(q[:, :, :m], k[:, :, :m], v[:, :, :m], **masks),
                           mha_masked_reference(q[:, :, m:], kc, vc, **masks)], dim=2)
        else:
            o = mha_masked_reference(q, kc, vc, **masks)
        x = _attn_residual(cfg, dense, p, x, o.transpose(1, 2).reshape(b, n, -1))
        x = _mlp_residual(cfg, dense, p, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x[:, -1] if rows is None else x[:, -rows:], params["lm_head"])


def phase_serve_mixed(st):
    """Llama-3-8B as configured (flash attention, random bf16 weights, 32
    layers) served from the mixed INT8-sink / INT4-bulk paged cache:
    bucketed prompts written split across the two pools, chunked and
    interleaved prompts through rows 10 + 11, fused decode through rows 3 +
    12 and the lse merge; then eight 2000-token prompts time decode at
    batch 8."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    from quantizedmha_tpu_torch.serving.kv_cache import MixedPageAllocator, PageAllocator

    # An earlier phase's engine sits in reference cycles with its model:
    # collect it, so that the peak below is this phase's.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sm_ = SERVE_MIXED
    mk = sm_["mixed"]
    cfg = llama.LlamaConfig.llama3_8b()
    L, page, bnd = cfg.num_layers, sm_["page"], mk["boundary_tokens"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = EngineConfig(page_size=page, prefill_buckets=(128, 256, 512, 1024, 2048), max_batch=8,
                        max_pages_per_seq=64, max_new_tokens=sm_["max_new"],
                        decode_chunk=sm_["chunk"], interleaved_prefill=True, mixed_kv=dict(mk))
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size
    prompts = [rng.integers(1, vocab, n).tolist() for n in sm_["bucketed"] + sm_["long"]]
    # Warm-up outside the measured run: a bucketed prompt and a two-chunk one.
    for n in (100, 2100):
        eng.add_request(rng.integers(1, vocab, n).tolist(), max_new=sm_["chunk"] + 1)
    eng.run()
    eng.finished.clear()

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "paged_prefill": pp.PAGED_PREFILL, "paged_prefill_int4": pp.PAGED_PREFILL_INT4,
               "paged_decode": dec.PAGED_DECODE, "paged_decode_int4": dec.PAGED_DECODE_INT4,
               "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P}
    counters = ("decode_steps", "tokens_generated", "prefill_chunks_interleaved",
                "requests_admitted", "prefill_tokens")
    base = {c: eng.metrics.counter(c) for c in counters}
    for kern in kernels.values():
        kern.reset()
    t_start = time.perf_counter()
    rids = [eng.add_request(p, max_new=sm_["max_new"]) for p in prompts]
    long_rid = rids[-1]
    # The 7900-token sequence's pages at its release: its final length.
    long_pages, release = [], eng.alloc.release

    def release_counting(seq_id):
        if seq_id == long_rid:
            long_pages.extend((len(eng.alloc.a8.tables[seq_id]),
                               len(eng.alloc.a4.tables[seq_id]), eng.alloc.lengths[seq_id]))
        release(seq_id)
    eng.alloc.release = release_counting
    ttft = {}
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        torch.cuda.synchronize()
        te = time.perf_counter()
        for rid in rids:
            if rid not in ttft and _first_token_at(eng, rid):
                ttft[rid] = te - t_start
    run_s = time.perf_counter() - t_start
    batch_prompts = [rng.integers(1, vocab, sm_["bucketed"][-1]).tolist() for _ in range(8)]
    batch_rids = [eng.add_request(p, max_new=sm_["decode_new"]) for p in batch_prompts]
    decode_wall = []
    while eng.queue or eng.active or eng.prefilling:
        before = {c: eng.metrics.counter(c) for c in ("requests_admitted", "decode_steps",
                                                      "tokens_generated")}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        d = {c: eng.metrics.counter(c) - before[c] for c in before}
        if (d["requests_admitted"] == 0 and d["decode_steps"] == sm_["chunk"]
                and d["tokens_generated"] == 8 * sm_["chunk"]):
            decode_wall.append(dt)
    launches = {name: kern.launches for name, kern in kernels.items()}
    delta = {c: eng.metrics.counter(c) - base[c] for c in counters}
    results = eng.finished
    n_chunks = sum(-(-n // 2048) for n in sm_["long"])
    n_bucketed = len(sm_["bucketed"]) + len(batch_rids)
    steps = int(delta["decode_steps"])
    want = {"flash_fwd[bf16]": L * n_bucketed, "flash_fwd[f32]": 0,
            "paged_prefill": L * n_chunks, "paged_prefill_int4": L * n_chunks,
            "paged_decode": L * steps, "paged_decode_int4": L * steps,
            "flash_int8_fwd[int8_p]": 0, "flash_int8_fwd[bf16_p]": 0}
    for name in ("flash_fwd[bf16]", "paged_prefill", "paged_prefill_int4", "paged_decode",
                 "paged_decode_int4"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    lens_ok = (all(len(results.get(r, [])) == sm_["max_new"] for r in rids)
               and all(len(results.get(r, [])) == sm_["decode_new"] for r in batch_rids))
    in_vocab = all(0 <= t < vocab for r in rids + batch_rids for t in results.get(r, []))
    drained = (eng.alloc.a8.free_pages == mk["int8_pages"] - 1
               and eng.alloc.a4.free_pages == mk["int4_pages"] - 1)
    counts_ok = (launches == want and delta["prefill_chunks_interleaved"] == n_chunks
                 and len(decode_wall) >= 4)
    if st["profile"]:
        # After the launch counts are read: the traced chunks launch too.
        profile_prompts = [rng.integers(1, vocab, sm_["bucketed"][-1]).tolist()
                           for _ in range(8)]
        emit({"phase": "serve_mixed_profile",
              **_profile_decode_chunk(eng, profile_prompts, 4 * sm_["chunk"])})

    # The 5000-token prompt's last logits, chunk-prefilled through a fresh
    # mixed cache (and, beside it, a plain INT8 cache), against the float
    # attention golden on the same tokens, and, gated, against the golden
    # whose attention reads K/V through the mixed cache's quantization (the
    # INT4 step itself moves the logits ~1 std of the float golden on these
    # random weights); the 2000-token bucketed prefill timed. Each path
    # runs twice; the second run is timed.
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    n_b, n_c, chunk = sm_["bucketed"][-1], sm_["long"][0], 2048
    toks = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
    toks[0, :n_b] = torch.tensor(prompts[len(sm_["bucketed"]) - 1], device="cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        tb = time.perf_counter()
        llama_adapter.prefill_at(cfg, params, toks, n_b - 1)
        torch.cuda.synchronize()
        bucket_s = time.perf_counter() - tb
    slots = -(-n_c // chunk) * chunk // page
    ctoks = torch.tensor(prompts[len(sm_["bucketed"])], dtype=torch.int32, device="cuda")

    def chunked(cache, table):
        for start in range(0, n_c, chunk):
            part = torch.zeros((1, chunk), dtype=torch.int32, device="cuda")
            n_part = min(chunk, n_c - start)
            part[0, :n_part] = ctoks[start:start + n_part]
            out, _ = llama_adapter.prefill_chunk(cfg, params, cache, part, start, table,
                                                 n_part - 1, page_size=page,
                                                 boundary_tokens=bnd)
        return out
    bp = bnd // page
    a = MixedPageAllocator(bp + 1, slots - bp + 1, page, bnd)
    a.admit(0, n_c)
    table = tuple(torch.tensor(t[0], device="cuda") for t in a.block_tables([0], slots - bp))
    cache = llama_adapter.make_cache_mixed(cfg, bp + 1, slots - bp + 1, page, mk["subs"],
                                           device="cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        tc = time.perf_counter()
        mixed_logits = chunked(cache, table)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - tc
    del cache
    plain = PageAllocator(slots + 1, page, scrap_page=0)
    plain.admit(0, n_c)
    cache = llama_adapter.make_cache(cfg, slots + 1, page, device="cuda")
    int8_logits = chunked(cache, torch.tensor(plain.block_table_array([0], slots)[0],
                                              device="cuda"))
    del cache
    ref = llama.forward(ref_cfg, params, ctoks[None])[:, -1]
    checks = {"mixed_chunked_5000": ((mixed_logits - ref).abs().max() / ref.std()).item(),
              "int8_chunked_5000": ((int8_logits - ref).abs().max() / ref.std()).item()}
    del ref
    ref = _kv_quantized_logits(cfg, params, ctoks[None], boundary=bnd, page=page,
                               subs=mk["subs"])
    gated = ((mixed_logits - ref).abs().max() / ref.std()).item()
    finite = bool(torch.isfinite(mixed_logits).all().item())
    del ref
    torch.cuda.empty_cache()

    n8, n4, n_long = long_pages or (0, 0, 0)
    kv_mixed = n8 * _cache_page_bytes(cfg, page) + n4 * _cache_page_bytes(cfg, page, mk["subs"])
    kv_int8 = -(-n_long // page) * _cache_page_bytes(cfg, page)
    dec_s = sum(decode_wall)
    dec_steps = sm_["chunk"] * len(decode_wall)
    ok = (lens_ok and in_vocab and counts_ok and drained and not eng.failed and finite
          and gated <= sm_["logit_tol"])
    emit({"phase": "serve_mixed", "ok": ok, "model": "llama3_8b", "attention_impl": "flash",
          "layers": L, "weights": "bf16", "init_s": init_s, "mixed_kv": mk,
          "prompts": list(sm_["bucketed"] + sm_["long"]), "max_new": sm_["max_new"],
          "decode_chunk": sm_["chunk"],
          "tokens_each": sorted({len(results.get(r, [])) for r in rids}),
          "failed": eng.failed, "launches": launches, "launches_expected": want,
          "counters": delta, "pools_drained": drained,
          "free_pages": [eng.alloc.a8.free_pages, eng.alloc.a4.free_pages], "run_s": run_s,
          "ttft_s": {n: ttft.get(r) for n, r in zip(sm_["bucketed"] + sm_["long"], rids)},
          "prefill_tok_s_bucketed": n_b / bucket_s, "prefill_2000_s": bucket_s,
          "prefill_tok_s_chunked": n_c / chunked_s, "prefill_chunked_5000_s": chunked_s,
          "decode_batch": 8, "decode_prompt_len": sm_["bucketed"][-1],
          "decode_new": sm_["decode_new"], "decode_engine_steps_timed": len(decode_wall),
          "decode_tok_s_batch8": 8 * dec_steps / dec_s if dec_s else None,
          "decode_ms_per_step_batch8": dec_s * 1e3 / dec_steps if dec_steps else None,
          "kv_bytes_long": {"tokens": n_long, "int8_pages": n8, "int4_pages": n4,
                            "mixed": kv_mixed, "plain_int8": kv_int8,
                            "ratio": kv_mixed / kv_int8 if kv_int8 else None},
          "logits_rel_err_vs_reference": checks,
          "logits_rel_err_vs_kv_quantized_golden": {"mixed_chunked_5000": gated},
          "rel_err_tol": sm_["logit_tol"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not ok:
        raise AssertionError("serve_mixed phase failed its checks")


# Gemma-2-9B from hybrid pools whose full group is the mixed INT8-sink /
# INT4-bulk pair: serve_hybrid's prompts without its prefix hit (JAX
# refuses prefix_cache here), plus one that stays inside the boundary.
# Pages of 128: the full group's INT8 pool holds 2 a sequence (boundary 256),
# its INT4 pool the rest (the 6000-token prompt and its 64 tokens: 46 pages;
# 1 + 13 + 46 = 60 for the three past the boundary); the sliding pool holds
# a prompt's pages until its prefill ends (6000 tokens: 47), then about the
# window (34): 80 leaves room for the others' growth meanwhile.
SERVE_HYBRID_MIXED = dict(bucketed=(100, 300, 1800), long=6000, max_new=64, chunk=8, page=128,
                          sliding_pages=80, max_pages=64, logit_tol=0.25,
                          mixed={"boundary_tokens": 256, "int8_pages": 16, "int4_pages": 80,
                                 "subs": 4})


class _LastDecodeLogits:
    """Each request's logits at its last decode step (the one that samples
    its last token), read off `eng`'s decode loop while in the with block
    (llama_adapter.decode_loop wrapped, then restored): {seq id: f32
    logits}."""

    def __init__(self, eng):
        self.eng, self.last = eng, {}

    def __enter__(self):
        from quantizedmha_tpu_torch.serving import llama_adapter
        loop = self.loop = llama_adapter.decode_loop

        def keeping_last(*a, **kw):
            toks, cache, logits = loop(*a, **dict(kw, return_logits=True))
            for lane, seq in enumerate(self.eng.active):
                j = seq.max_new - 1 - len(seq.out)
                if 0 <= j < logits.shape[0]:
                    self.last[seq.seq_id] = logits[j, lane].float().clone()
            return toks, cache
        llama_adapter.decode_loop = keeping_last
        return self.last

    def __exit__(self, *exc):
        from quantizedmha_tpu_torch.serving import llama_adapter
        llama_adapter.decode_loop = self.loop


def phase_serve_hybrid_mixed(st):
    """Gemma-2-9B as configured (random bf16 weights) through the engine
    with hybrid_kv and mixed_kv: the full layers' pool is the mixed pair
    (INT8 below 256 tokens, INT4 past), the sliding layers' plain INT8;
    interleaved chunked prefill, decode chunks of 8 (_gemma2_pools_run).
    Rows 3, 5, 10, 11 and 12 run at head_dim 256. Each request's last
    decode logits are held to the golden whose float attention reads K/V
    through the same INT8 / INT4 quantization (_last_logits_gate)."""
    import torch
    from quantizedmha_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sh = SERVE_HYBRID_MIXED
    mk = sh["mixed"]
    cfg = llama.LlamaConfig.gemma2_9b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    run = _gemma2_pools_run(st, cfg, params, sh, mixed=True, launches_key="launches_d256")
    gated, vs_float, finite = _last_logits_gate(
        cfg, params, run, sh, boundary=mk["boundary_tokens"], subs=mk["subs"],
        vs_float=[name for name, _, _ in run["requests"]])
    ok = run["ok"] and finite and max(gated.values()) <= sh["logit_tol"]
    emit({"phase": "serve_hybrid_mixed", "ok": ok, "model": "gemma2_9b",
          "layers": cfg.num_layers, "head_dim": cfg.hd, "attention_impl": cfg.attention_impl,
          "weights": "bf16", "init_s": init_s, **run["report"],
          "kv_bytes_long_serve_hybrid": 0.892e9,
          "last_logits_rel_err_vs_kv_quantized_golden": gated,
          "last_logits_rel_err_vs_float_golden": vs_float, "rel_err_tol": sh["logit_tol"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not ok:
        raise AssertionError("serve_hybrid_mixed phase failed its checks")


def _gemma2_pools_run(st, cfg, params, sh, *, mixed, launches_key):
    """One run of serve_hybrid's traffic (sh's prompts, page 128,
    interleaved prefill, decode chunks) through the engine on Gemma-2 in
    cfg's dtype, the kernel counters zeroed just before the traffic and
    added to st["launches"] and st[launches_key] just after. mixed False:
    hybrid INT8 pools (sh["pages"]) with prefix caching and the prefix hit,
    then the same traffic through one shared pool, whose streams the
    hybrid run's must equal (page contents are the same, only the page ids
    differ). mixed True: hybrid pools whose full group is sh["mixed"]'s
    INT8 / INT4 pair, no prefix cache (mixed_kv refuses it). Returns the
    run's record: "ok" (launches exact, counters, streams, pools drained,
    page use), "report" (the keys a phase emits), and the prompts, request
    ids, streams and each request's last decode logits for the phase's own
    logit gate."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

    L, P = cfg.num_layers, sh["page"]
    mk = sh["mixed"] if mixed else None
    groups = llama_adapter.window_groups(cfg)
    F = len(groups["full"])

    def engine(hybrid):
        pools = (dict(hybrid_pages={"w4096": sh["sliding_pages"]}, mixed_kv=dict(mk)) if mixed
                 else dict(num_pages=sh["pages"]["full"], prefix_cache=True,
                           hybrid_pages=dict(sh["pages"]) if hybrid else None))
        return Engine(cfg, params, EngineConfig(
            page_size=P, max_batch=4, max_pages_per_seq=sh["max_pages"],
            prefill_buckets=(128, 256, 512, 1024, 2048), max_new_tokens=sh["max_new"],
            decode_chunk=sh["chunk"], interleaved_prefill=True, hybrid_kv=hybrid, **pools),
            device="cuda")
    eng = engine(True)
    assert eng.hybrid and set(eng.allocs) == {"full", "w4096"}
    assert eng.hybrid_mixed == mixed
    full, sliding = eng.allocs["full"], eng.allocs["w4096"]
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size
    lens = tuple(sh["bucketed"]) + (sh["long"],)
    prompts = [rng.integers(1, vocab, n).tolist() for n in lens]
    hit = (None if mixed else prompts[-1][:sh["shared_pages"] * P]
           + rng.integers(1, vocab, sh["hit_suffix"]).tolist())
    # Warm-up (first cuBLAS and kernel use) on tokens no later prompt shares.
    for n in (100, 2100):
        eng.add_request(rng.integers(1, vocab, n).tolist(), max_new=sh["chunk"] + 1)
    eng.run()
    eng.finished.clear()

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "paged_prefill": pp.PAGED_PREFILL, "paged_prefill_int4": pp.PAGED_PREFILL_INT4,
               "paged_decode": dec.PAGED_DECODE, "paged_decode_int4": dec.PAGED_DECODE_INT4}
    counters = ("decode_steps", "prefill_chunks_interleaved", "requests_admitted",
                "pages_trimmed") + (() if mixed else ("prefix_cache_hits",
                                                       "prefix_tokens_reused"))
    base = {c: eng.metrics.counter(c) for c in counters}
    sliding_cap = -(-(4096 + P) // P) + 1
    seen = {"max_sliding": 0, "long_full": 0, "long_live": {}, "int4_used": 0}

    def watch(e, rids, hit_rid):
        if mixed:
            seen["int4_used"] = max(seen["int4_used"],
                                    full.a4.num_pages - 1 - full.a4.free_pages)
            if rids[-1] in full.lengths:  # the long sequence's pages at its last step
                seen["long_live"] = {"int8": len(full.a8.tables[rids[-1]]),
                                     "int4": len(full.a4.tables[rids[-1]]),
                                     "sliding": sum(p is not None
                                                    for p in sliding.tables[rids[-1]])}
            return
        for k, a in e.allocs.items():
            for rid, table in a.tables.items():
                live = sum(p is not None for p in table)
                if k == "w4096" and any(s.seq_id == rid for s in e.active):
                    seen["max_sliding"] = max(seen["max_sliding"], live)
                if rid == rids[-1]:  # the long sequence's pages at its last step
                    seen["long_live"][k] = live
                    if k == "full":
                        seen["long_full"] = max(seen["long_full"], live)
    for kern in kernels.values():
        kern.reset()
    with _LastDecodeLogits(eng) as last:
        t_run = time.perf_counter()
        rids, hit_rid, ttft, walls = _hybrid_traffic(eng, prompts, hit, sh, on_step=watch)
        run_s = time.perf_counter() - t_run
    launches = {name: kern.launches for name, kern in kernels.items()}
    delta = {c: eng.metrics.counter(c) - base[c] for c in counters}
    got = dict(eng.finished)
    n_chunks = -(-sh["long"] // 2048)
    steps = int(delta["decode_steps"])
    flash = "flash_fwd[f32]" if cfg.dtype == torch.float32 else "flash_fwd[bf16]"
    want = {flash: L * len(sh["bucketed"]), "paged_decode": L * steps,
            # the hit's suffix fits one chunk
            "paged_prefill": L * (n_chunks + (0 if mixed else 1))}
    if mixed:
        want.update(paged_prefill_int4=F * n_chunks, paged_decode_int4=F * steps)
    want = {name: want.get(name, 0) for name in kernels}
    for name, n in launches.items():
        st["launches"][name] = st["launches"].get(name, 0) + n
        st[launches_key][name] = st[launches_key].get(name, 0) + n
    if mixed:
        drained = (not full.lengths and full.a8.free_pages == mk["int8_pages"] - 1
                   and full.a4.free_pages == mk["int4_pages"] - 1)
    else:
        drained = not full.tables and full.free_pages == full.num_pages - 1
    drained = drained and not sliding.tables and sliding.free_pages == sliding.num_pages - 1
    # KV bytes of the long sequence at its last step: INT8 (INT4) K and V
    # rows and their per-(head, page (sub-tile)) scales, pages x layers.
    page8 = 2 * cfg.num_kv_heads * (P * cfg.hd + 4)
    lp = seen["long_live"]
    if mixed:
        page4 = 2 * cfg.num_kv_heads * (P * cfg.hd // 2 + 4 * mk["subs"])
        kv_long = (F * (lp.get("int8", 0) * page8 + lp.get("int4", 0) * page4)
                   + len(groups["w4096"]) * lp.get("sliding", 0) * page8)
    else:
        kv_long = sum(lp.get(k, 0) * len(groups[k]) * page8 for k in groups)
    dec_s = sum(w for w, _ in walls)
    dec_steps = sh["chunk"] * len(walls)
    failed = dict(eng.failed)
    del eng, full, sliding
    gc.collect()
    torch.cuda.empty_cache()

    all_rids = rids + ([] if mixed else [hit_rid])
    ok = (launches == want and not failed and drained and delta["pages_trimmed"] > 0
          and (mixed or hit_rid is not None)
          and all(len(got.get(r, [])) == sh["max_new"] for r in all_rids)
          and all(0 <= t < vocab for r in all_rids for t in got.get(r, [])))
    report = {"groups": {k: len(v) for k, v in groups.items()},
              "prompts": list(lens), "max_new": sh["max_new"], "decode_chunk": sh["chunk"],
              "launches": launches, "launches_expected": want, "counters": delta,
              "kv_bytes_long": kv_long, "pools_drained": drained, "failed": failed,
              "run_s": run_s,
              "ttft_s": dict({n: ttft.get(r) for n, r in zip(lens, rids)},
                             **({} if mixed else {"prefix_hit": ttft.get(hit_rid)})),
              "decode_engine_steps_timed": len(walls),
              "decode_batches": sorted({b for _, b in walls}),
              "decode_ms_per_step": dec_s * 1e3 / dec_steps if dec_steps else None}
    if mixed:
        int4_ok = seen["int4_used"] >= -(-(sh["long"] - mk["boundary_tokens"]) // P)
        ok = ok and int4_ok and delta["prefill_chunks_interleaved"] == n_chunks
        report.update(mixed_kv=mk, sliding_pages=sh["sliding_pages"],
                      int4_pages_max_used=seen["int4_used"], long_pages_last_step=lp)
    else:
        ref = engine(False)
        assert not ref.hybrid
        long_pages = {"n": 0}

        def watch_shared(e, rids, hit_rid):
            if rids[-1] in e.alloc.tables:
                long_pages["n"] = max(long_pages["n"], len(e.alloc.tables[rids[-1]]))
        r_rids, r_hit, _, _ = _hybrid_traffic(ref, prompts, hit, sh, on_step=watch_shared)
        want_streams = dict(ref.finished)
        kv_shared = long_pages["n"] * L * page8
        same = [got.get(a) == want_streams.get(b) for a, b in zip(rids, r_rids)]
        hit_len_ok = (len(got.get(hit_rid, [])) == len(want_streams.get(r_hit, []))
                      == sh["max_new"])
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        ok = (ok and all(same) and hit_len_ok and delta["prefix_cache_hits"] == 1
              and delta["prefix_tokens_reused"] == sh["shared_pages"] * P
              and delta["prefill_chunks_interleaved"] > 0
              and seen["max_sliding"] <= sliding_cap
              and seen["long_full"] >= -(-sh["long"] // P))
        report.update(pool_pages=sh["pages"],
                      pool_bytes={k: sh["pages"][k] * len(groups[k]) * page8 for k in groups},
                      prefix_hit={"len": len(hit), "shared_tokens": sh["shared_pages"] * P},
                      streams_equal_shared_pool=same, hit_stream_len_equal=hit_len_ok,
                      sliding_pages_max_live=seen["max_sliding"], sliding_pages_cap=sliding_cap,
                      long_full_pages=seen["long_full"], long_live_pages=lp,
                      kv_bytes_long_shared=kv_shared,
                      kv_ratio=kv_long / kv_shared if kv_shared else None)
    names = list(zip(lens, prompts, rids)) + ([] if mixed else [("prefix_hit", hit, hit_rid)])
    return {"ok": ok, "report": report, "requests": names, "streams": got, "last": last}


def _last_logits_gate(cfg, params, run, sh, *, boundary, subs, vs_float=()):
    """Each request's last decode logits (run["last"]) against the golden
    over the same tokens (its prompt and all but its last sampled token)
    whose float attention reads K/V through the pools' quantization
    (_kv_quantized_logits: INT8 below `boundary`, INT4 of `subs` sub-tiles
    past it; a bucketed
    prompt's own rows over its float K/V, as the flash prefill computes
    them), as a share of the golden's std: ({request: share}, {request in
    vs_float: share of the float golden's std}, all finite). A request
    whose stream or logits are missing counts inf."""
    import torch
    from quantizedmha_tpu_torch.serving import llama_adapter
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    gated, floats, finite = {}, {}, True
    for name, prompt, rid in run["requests"]:
        out = run["streams"].get(rid, [])
        if len(out) != sh["max_new"] or rid not in run["last"]:
            gated[name] = float("inf")
            continue
        toks = torch.tensor(prompt + out[:-1], dtype=torch.int32, device="cuda")[None]
        logits = run["last"][rid]
        finite = finite and bool(torch.isfinite(logits).all().item())
        golden = _kv_quantized_logits(cfg, params, toks, boundary=boundary, page=sh["page"],
                                      subs=subs, n_written=len(prompt),
                                      float_prompt=name in sh["bucketed"])[0].float()
        gated[name] = ((logits - golden).abs().max() / golden.std()).item()
        del golden
        if name in vs_float:
            golden = llama_adapter.prefill_at(ref_cfg, params, toks,
                                              toks.shape[1] - 1)[0][0].float()
            floats[name] = ((logits - golden).abs().max() / golden.std()).item()
            del golden
        torch.cuda.empty_cache()
    return gated, floats, finite


# serve_gemma2_f32: Gemma-2-9B in f32 at full width and depth (42 layers,
# 10.16e9 parameters, 40.6 GB beside pools of 1.6 GB), serve_hybrid's
# prompts with max_new cut from 64 to 32 (the phase's time: an f32 decode
# step reads the 40.6 GB of weights), once through serve_hybrid's INT8
# pools with the prefix hit ("int8": rows 3, 5 and 10 in f32 at d=256) and
# once through serve_hybrid_mixed's, whose full group is the mixed INT8 /
# INT4 pair ("mixed": rows 3, 5, 10, 11 and 12; no prefix cache: mixed_kv
# refuses it). logit_tol: each request's last decode logits against the
# golden whose float attention reads K/V through the same INT8 / INT4 quantization
# (_kv_quantized_logits; a bucketed prompt's own rows over its float K/V,
# as the flash prefill computes them), as a share of the golden's std. The
# two sum every product of 42 layers in other orders. In bf16
# (serve_hybrid_mixed) each rounding is 2^-9 and 0.25 std is allowed; in
# f32 each is 2^-24, which scales that down to 8e-6 std. The cache's
# quantization turns the order's ulps into whole steps: a K or V element
# that the two orders put on either side of an int8 / int4 rounding
# boundary differs by a step (1/127 of its page's largest |x|, 1/7 in
# INT4), thousands of elements over 42 layers and 6000 tokens. That is the
# distance measured (NVIDIA H100 80GB HBM3, 700 W): 0.0030-0.0056 std on
# the chunked and prefix-hit requests, three orders above the order's own
# 8e-6. The gate allows 2^-6 = 0.0156 std, 2.8x the largest seen. The
# bucketed requests against a golden that reads their prompt through the
# cache (a quantization the engine does not make there) stand at
# 0.069-0.089 std: a wrong page, scale or tile moves the logits past the
# gate.
SERVE_GEMMA2_F32 = {kind: dict(base, bucketed=SERVE_HYBRID["bucketed"], max_new=32,
                               logit_tol=2.0**-6)
                    for kind, base in (("int8", SERVE_HYBRID), ("mixed", SERVE_HYBRID_MIXED))}


def phase_serve_gemma2_f32(st):
    """LlamaConfig.gemma2_9b() with dtype float32 (42 layers, head_dim 256,
    a 4096 window on even layers, softcaps 50 and 30, attention_impl=
    "flash", random f32 weights from a seeded generator) through the
    engine as serve_hybrid and serve_hybrid_mixed drive it
    (_gemma2_pools_run): (a) hybrid INT8 pools, prefix caching and
    interleaved prefill, then the same traffic through one shared pool;
    (b) hybrid pools with the mixed INT8 / INT4 full group. Every prefill
    attention runs the f32 routes at d=256: row 5's CUDA-core kernel, rows
    10 and 11 with f32 q. Each request's last decode logits are held to
    the KV-quantized golden (_last_logits_gate)."""
    import torch
    from quantizedmha_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
    cfg = dataclasses.replace(llama.LlamaConfig.gemma2_9b(), dtype=torch.float32)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [x for x in _flat_tree(params).values() if isinstance(x, torch.Tensor)]
    n_params = sum(x.numel() for x in leaves)
    weights_gb = sum(x.numel() * x.element_size() for x in leaves) / 1e9
    del leaves
    mk = SERVE_GEMMA2_F32["mixed"]["mixed"]
    runs = {}
    for name, kind in (("hybrid_int8", "int8"), ("hybrid_mixed", "mixed")):
        sh = SERVE_GEMMA2_F32[kind]
        run = _gemma2_pools_run(st, cfg, params, sh, mixed=kind == "mixed",
                                launches_key="launches_d256_f32")
        # The long request beside the float golden (no quantization), whose
        # distance the cache's quantization sets.
        gated, vs_float, finite = _last_logits_gate(
            cfg, params, run, sh, boundary=mk["boundary_tokens"] if kind == "mixed" else 1 << 30,
            subs=mk["subs"], vs_float=[sh["long"]])
        runs[name] = dict(run["report"],
                          ok=run["ok"] and finite and max(gated.values()) <= sh["logit_tol"],
                          last_logits_rel_err_vs_kv_quantized_golden=gated,
                          long_last_logits_rel_err_vs_float_golden=vs_float.get(sh["long"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ok = all(r["ok"] for r in runs.values())
    emit({"phase": "serve_gemma2_f32", "ok": ok, "model": "gemma2_9b", "dtype": "float32",
          "layers": cfg.num_layers, "head_dim": cfg.hd, "attention_impl": cfg.attention_impl,
          "params": n_params, "weights_gb": weights_gb, "init_s": init_s,
          "rel_err_tol": SERVE_GEMMA2_F32["int8"]["logit_tol"], **runs,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "mem_at_start_gb": mem_at_start})
    if not ok:
        raise AssertionError("serve_gemma2_f32 phase failed its checks")


# Speculative decoding on Gemma-2-9B (hybrid pools), with a draft of the
# target's first two layers (pattern (4096, None): hybrid pools too; the
# same embedding, final norm and lm_head). Prompts: 300 and 1800 tokens
# (bucketed), 5000 (chunked, past the window at admission) and 4200 (its
# window edge crosses a page while it decodes: trims under speculation).
# verify_step is held to the KV-quantized golden (logit_tol std of its
# logits), once on a shared prefix and once on a full batch of the
# self-speculation run; the verify/decode logit delta may not pass
# delta_ulps bf16 ulps at the golden's largest logit; verify_faults are
# planted in turn, and each must fail one of these gates.
SERVE_SPEC = dict(prompts=(300, 1800, 5000, 4200), max_new=48, k=4, page=128, pages=110,
                  max_pages=64, adaptive=(2, 6),
                  sampling=dict(temperature=0.8, top_p=0.95, seed=5),
                  logit_tol=0.25, delta_ulps=8,
                  verify_faults=("wrong_slot", "stale_page", "wrong_offset"))


class _AdapterCalls:
    """While active, counts the launches that the adapter calls made imply
    (each layer of each call one launch of its kernel): prefill_at the
    float flash kernel, prefill_chunk and verify_step the paged prefill,
    decode_loop the paged decode a step; verify_step calls and the batch
    lanes they verified besides."""

    def __init__(self):
        self.want = {"flash_fwd[bf16]": 0, "paged_prefill": 0, "paged_decode": 0}
        self.verify_calls = 0

    def __enter__(self):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        self.saved = {n: getattr(la, n) for n in ("prefill_at", "prefill_chunk", "verify_step",
                                                  "decode_loop")}

        def counting(name, kernel, steps=lambda kw: 1):
            fn = self.saved[name]

            def call(cfg, *a, **kw):
                self.want[kernel] += cfg.num_layers * steps(kw)
                if name == "verify_step":
                    self.verify_calls += 1
                return fn(cfg, *a, **kw)
            return call
        la.prefill_at = counting("prefill_at", "flash_fwd[bf16]")
        la.prefill_chunk = counting("prefill_chunk", "paged_prefill")
        la.verify_step = counting("verify_step", "paged_prefill")
        la.decode_loop = counting("decode_loop", "paged_decode", lambda kw: kw["n_steps"])
        return self

    def __exit__(self, *exc):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        for n, fn in self.saved.items():
            setattr(la, n, fn)


class _VerifyWatch:
    """While active over a SpecDecodeEngine `eng`: the target's top-2 logit
    gap (verify_step's logits) at every draft position that a sequence of a
    round had checked (`checked`), and for each sequence of each round
    whose drafts the target's argmax rejects, at the first rejected
    position (`gaps`); and the last verify call over a full batch (`full`:
    each lane's tokens, the prompt's length among them, and the call's
    logits [B, k + 1, vocab])."""

    def __init__(self, eng):
        self.eng, self.gaps, self.checked, self.full = eng, [], [], None

    def __enter__(self):
        import torch
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        self.saved = (la.decode_loop, la.verify_step)
        loop, verify = self.saved
        drafts = {}

        def draft_loop(*a, **kw):
            out = loop(*a, **kw)
            drafts["last"] = out[0].cpu()  # [k, B]
            return out

        def verify_watched(cfg, params, cache, tokens, positions0, *a, **kw):
            logits, cache = verify(cfg, params, cache, tokens, positions0, *a, **kw)
            top = logits.float().topk(2, dim=-1).values
            gap = (top[..., 0] - top[..., 1]).cpu()  # [B, S]
            best = torch.argmax(logits, dim=-1).cpu()  # the engine's choice, ties too
            d = drafts["last"]
            active = self.eng.active
            for lane in range(len(active)):
                miss = (d[:, lane] != best[lane, :d.shape[0]]).nonzero()
                last = int(miss[0]) if len(miss) else d.shape[0] - 1
                self.checked += gap[lane, :last + 1].tolist()
                if len(miss):
                    self.gaps.append(gap[lane, last].item())
            if len(active) == self.eng.ecfg.max_batch:
                fed, pos0 = tokens.tolist(), positions0.tolist()
                lanes = [(s.prompt + s.out + fed[i][1:], len(s.prompt))
                         for i, s in enumerate(active)]
                # The cache holds the prompt and every token out but the
                # pending one, fed first: the rows are positions pos0..
                if any(len(t) != p0 + len(f) for (t, _), p0, f in zip(lanes, pos0, fed)):
                    raise AssertionError("verify's rows are not the lanes' next positions")
                self.full = (lanes, logits.float().clone())
            return logits, cache
        la.decode_loop, la.verify_step = draft_loop, verify_watched
        return self

    def __exit__(self, *exc):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        la.decode_loop, la.verify_step = self.saved


class _VerifyFault:
    """While active, verify_step runs with one argument wrong, as a faulty
    caller or schedule would pass it: `wrong_slot` appends each token's K/V
    one slot further on (the last slot wraps to the page's first, which
    refits its scale), `stale_page` appends to the scrap page (attention
    reads the sequence's stale slots), `wrong_offset` takes every position
    (RoPE, q_starts, lengths) one token early."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import torch
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        self.saved = verify = la.verify_step
        name = self.name

        def faulty(cfg, params, cache, tokens, positions0, page_sched, slot_sched, tables, *,
                   page_size, **kw):
            if name == "wrong_slot":
                slot_sched = (slot_sched + 1) % page_size
            elif name == "stale_page":
                page_sched = ({g: torch.zeros_like(t) for g, t in page_sched.items()}
                              if isinstance(page_sched, dict) else torch.zeros_like(page_sched))
            elif name == "wrong_offset":
                positions0 = positions0 - 1
            else:
                raise ValueError(f"unknown verify fault {name}")
            return verify(cfg, params, cache, tokens, positions0, page_sched, slot_sched, tables,
                          page_size=page_size, **kw)
        la.verify_step = faulty
        return self

    def __exit__(self, *exc):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        la.verify_step = self.saved


def _bf16_ulp(cfg, logit: float) -> float:
    """One bf16 ulp of a logit before the final softcap (the lm_head's
    bf16 output): the unit that two correct roundings of it differ in."""
    cap = cfg.final_logit_softcap
    x = abs(logit)
    if cap is not None:
        x = cap * math.atanh(min(x / cap, 1 - 2.0 ** -24))
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def _verify_on_prefix(cfg, params, prompt, tokens, P):
    """`tokens` fed after `prompt` (prefilled into two fresh hybrid pools
    alike): decode_step one token at a time in one, verify_step all at once
    in the other. Returns max |verify - decode| over their logits, each
    path's max |logit - golden| / std(golden) over the same rows (the
    golden: float attention over the pools' INT8 quantization, tokens past
    the prompt quantized as appends are), and the golden's max |logit|."""
    import torch
    from quantizedmha_tpu_torch.serving import llama_adapter as la
    n, S = len(prompt), len(tokens)
    groups = la.window_groups(cfg)
    slots = -(-(n + S) // P)
    table = {k: torch.arange(1, slots + 1, dtype=torch.int32, device="cuda")[None]
             for k in groups}
    bucket = max(128, 1 << (n - 1).bit_length())  # the engine's bucket (n <= 2048)
    toks = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.tensor(prompt, device="cuda")
    _, k_all, v_all = la.prefill_at(cfg, params, toks, n - 1)
    n_w = -(-n // P) * P
    keep = (torch.arange(n_w, device="cuda") < n)[None, None, :, None]
    caches = []
    for _ in range(2):
        c = la.make_cache_hybrid(cfg, {k: slots + 1 for k in groups}, P, device="cuda")
        la.write_prefill_hybrid(cfg, c, k_all[:, :, :n_w] * keep, v_all[:, :, :n_w] * keep,
                                {k: t[0, :n_w // P] for k, t in table.items()}, page_size=P)
        caches.append(c)
    del k_all, v_all
    pos = torch.arange(n, n + S, device="cuda")
    fed = torch.tensor(tokens, dtype=torch.int32, device="cuda")
    step_logits = []
    for j in range(S):
        p = pos[j:j + 1]
        logits, _ = la.decode_step(cfg, params, caches[0], fed[j:j + 1], p.int(),
                                   {k: t[0, p // P] for k, t in table.items()}, (p % P).int(),
                                   (p + 1).int(), table)
        step_logits.append(logits[0].float())
    ver, _ = la.verify_step(cfg, params, caches[1], fed[None], pos[:1].int(),
                            {k: t[:, pos // P] for k, t in table.items()},
                            (pos % P).int()[None], table, page_size=P)
    del caches
    step, ver = torch.stack(step_logits), ver[0].float()
    ref = _kv_quantized_logits(cfg, params, torch.tensor(prompt + list(tokens), dtype=torch.int32,
                                                         device="cuda")[None],
                               boundary=slots * P, page=P, subs=1, n_written=n,
                               rows=S)[0].float()
    std = ref.std()
    return {"delta": (step - ver).abs().max().item(),
            "verify_vs_golden": ((ver - ref).abs().max() / std).item(),
            "decode_vs_golden": ((step - ref).abs().max() / std).item(),
            "golden_max_abs_logit": ref.abs().max().item()}


def _full_batch_vs_golden(cfg, params, full, P):
    """Each lane of a verify call over a full batch (_VerifyWatch.full):
    max |logit - golden| / std(golden) over its k + 1 rows, the golden over
    the lane's tokens as _verify_on_prefix takes it."""
    import torch
    lanes, logits = full
    out = []
    for lane, (toks, n_prompt) in enumerate(lanes):
        S = logits.shape[1]
        ref = _kv_quantized_logits(cfg, params, torch.tensor(toks, dtype=torch.int32,
                                                             device="cuda")[None],
                                   boundary=-(-len(toks) // P) * P, page=P, subs=1,
                                   n_written=n_prompt, rows=S)[0].float()
        out.append(((logits[lane] - ref).abs().max() / ref.std()).item())
        del ref
        torch.cuda.empty_cache()
    return out


def _verify_gates(cfg, ss, prefix, self_run, full_batch, tie_share):
    """serve_spec's gates on verify_step, from one self-speculation run
    (greedy, the target as its own draft) and _verify_on_prefix: verify's
    and decode's logits within logit_tol std of the golden on the prefix,
    and verify's on the run's full batch; the verify/decode delta at most
    delta_ulps bf16 ulps of the golden's largest logit; every rejection at
    a top-2 gap below twice that delta; acceptance at least what rejecting
    at every near-tie would leave (a near-tie: the plain engine's top-2 gap
    within one bf16 ulp of its top logit, `tie_share` of its positions;
    k drafts a round). Returns (gates, delta cap, acceptance floor)."""
    k, tol = ss["k"], ss["logit_tol"]
    cap = ss["delta_ulps"] * _bf16_ulp(cfg, prefix["golden_max_abs_logit"])
    floor = sum((1 - tie_share) ** j for j in range(1, k + 1)) / k
    gates = {
        "golden_prefix": max(prefix["verify_vs_golden"], prefix["decode_vs_golden"]) <= tol,
        "golden_full_batch": bool(full_batch) and max(full_batch) <= tol,
        "delta_capped": prefix["delta"] <= cap,
        "rejections_near_ties": all(g < 2 * prefix["delta"]
                                    for g in self_run["rejection_top2_gaps"]),
        "acceptance_floor": self_run["acceptance"] >= floor}
    return gates, cap, floor


def phase_serve_spec(st):
    """Speculative decoding on Gemma-2-9B as configured (random bf16
    weights, hybrid_kv) with a two-layer draft cut from it: (a) greedy at
    k = 4, held to the plain hybrid engine's streams up to a first
    divergence that only a near-tie allows; (b) self-speculation (the
    target as its own draft), held by _verify_gates, which each planted
    verify fault must fail; (c) adaptive k from 2 up to 6; (d) temperature
    0.8, top-p 0.95. Row 10 runs at verify's shape (4 sequences of k + 1
    rows, each at its own offset), rows 3 and 5 on both models."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    from quantizedmha_tpu_torch.serving.sampling import SamplingParams
    from quantizedmha_tpu_torch.serving.speculative import SpecConfig, SpecDecodeEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ss = SERVE_SPEC
    cfg = llama.LlamaConfig.gemma2_9b()
    L, P = cfg.num_layers, ss["page"]
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    dcfg = dataclasses.replace(cfg, num_layers=2, window_pattern=(4096, None))
    dparams = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size
    prompts = [rng.integers(1, vocab, n).tolist() for n in ss["prompts"]]

    def ecfg(**kw):
        return EngineConfig(**dict(dict(
            page_size=P, max_batch=4, max_pages_per_seq=ss["max_pages"],
            prefill_buckets=(128, 256, 512, 1024, 2048), max_new_tokens=ss["max_new"],
            hybrid_kv=True, hybrid_pages={"full": ss["pages"], "w4096": ss["pages"]}), **kw))

    def pools(e):
        return list(e.allocs.values()) + list(e.draft_allocs.values())

    def drive(eng):
        """Serve the prompts: (streams by prompt, wall s, decode-only walls
        and tokens, pages freed by rollbacks)."""
        freed = {"pages": 0}
        for a in pools(eng):
            def rollback(seq_id, new_len, a=a, fn=a.rollback):
                before = a.free_pages
                fn(seq_id, new_len)
                freed["pages"] += a.free_pages - before
            a.rollback = rollback
        rids = [eng.add_request(p) for p in prompts]
        walls, t0 = [], time.perf_counter()
        while eng.queue or eng.active or eng.prefilling:
            before = {c: eng.metrics.counter(c) for c in ("requests_admitted",
                                                          "tokens_generated")}
            torch.cuda.synchronize()
            ts = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if eng.metrics.counter("requests_admitted") == before["requests_admitted"]:
                walls.append((time.perf_counter() - ts, eng.metrics.counter("tokens_generated")
                              - before["tokens_generated"]))
        return ([eng.finished.get(r, []) for r in rids], time.perf_counter() - t0, walls,
                freed["pages"])

    def serve(draft_cfg, draft_params, scfg, **kw):
        """One run over the prompts: (its record, its streams, its watch)."""
        eng = SpecDecodeEngine(cfg, params, draft_cfg, draft_params, ecfg(**kw), scfg,
                               device="cuda")
        assert eng.hybrid and eng.draft_hybrid
        with _VerifyWatch(eng) as watch:
            streams, wall, walls, freed = drive(eng)
        watch.eng = None  # the engine's pools go with it below
        m = eng.metrics
        dec_s, dec_tok = sum(w for w, _ in walls), sum(t for _, t in walls)
        run = {
            "acceptance": eng.acceptance_rate, "spec_rounds": m.counter("spec_rounds"),
            "tokens_generated": m.counter("tokens_generated"),
            "target_forwards_per_token": (m.counter("spec_rounds")
                                          / max(m.counter("tokens_generated"), 1)),
            "k_final": eng._k, "k_changes": m.counter("spec_k_changes"),
            "pages_trimmed": m.counter("pages_trimmed"),
            "pages_freed_by_rollback": freed, "run_s": wall,
            "decode_tok_s": dec_tok / dec_s if dec_s else None,
            "drained": all(not a.tables and a.free_pages == a.num_pages - 1
                           for a in pools(eng)),
            "lens_ok": all(len(s) == ss["max_new"] for s in streams),
            "in_vocab": all(0 <= t < vocab for s in streams for t in s),
            "failed": dict(eng.failed)}
        if eng.sampling.greedy:
            run["rejection_top2_gaps"] = watch.gaps
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return run, streams, watch

    # Warm-up (first use of every shape's cuBLAS and kernels) off the record.
    warm = SpecDecodeEngine(cfg, params, dcfg, dparams, ecfg(),
                            SpecConfig(num_draft_tokens=ss["k"]), device="cuda")
    warm.add_request(rng.integers(1, vocab, 100).tolist(), max_new=9)
    warm.run()
    del warm

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "paged_prefill": pp.PAGED_PREFILL,
               "paged_decode": dec.PAGED_DECODE}
    runs, results, watches = {}, {}, {}
    for kern in kernels.values():
        kern.reset()
    pp.split_launches["paged_prefill"] = 0
    with _AdapterCalls() as calls:
        for name, (d_cfg, d_params, scfg, kw) in {
                "greedy_k4": (dcfg, dparams, SpecConfig(num_draft_tokens=ss["k"]), {}),
                "self_k4": (cfg, params, SpecConfig(num_draft_tokens=ss["k"]), {}),
                "adaptive": (dcfg, dparams, SpecConfig(
                    num_draft_tokens=ss["adaptive"][0], adaptive=True, min_k=1,
                    max_k=ss["adaptive"][1]), {}),
                "sampled": (dcfg, dparams, SpecConfig(num_draft_tokens=ss["k"]),
                            dict(sampling=SamplingParams(**ss["sampling"])))}.items():
            runs[name], results[name], watches[name] = serve(d_cfg, d_params, scfg, **kw)
    launches = {name: kern.launches for name, kern in kernels.items()}
    # Row 10's launches that took the split key walk (S > 1): verify's.
    split_launches = pp.split_launches["paged_prefill"]
    for name, n in launches.items():
        st["launches"][name] = st["launches"].get(name, 0) + n
        st["launches_d256"][name] = st["launches_d256"].get(name, 0) + n

    # The plain hybrid engine (decode_chunk 1) on the same prompts, each
    # step's top-2 logit gap and top logit kept by (request, token index).
    ref = Engine(cfg, params, ecfg(), device="cuda")
    gaps, step = {}, llama_adapter.decode_step

    def step_keeping_gaps(*a, **kw):
        logits, cache = step(*a, **kw)
        top = logits.float().topk(2, dim=-1).values
        for lane, seq in enumerate(ref.active):
            gaps[(seq.seq_id, len(seq.out))] = ((top[lane, 0] - top[lane, 1]).item(),
                                                top[lane, 0].item())
        return logits, cache
    llama_adapter.decode_step = step_keeping_gaps
    try:
        rids = [ref.add_request(p) for p in prompts]
        ref.run()
    finally:
        llama_adapter.decode_step = step
    plain = [ref.finished.get(r, []) for r in rids]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    tie_share = sum(g <= _bf16_ulp(cfg, t) for g, t in gaps.values()) / len(gaps)

    def verify_checks(self_run, watch):
        prefix = _verify_on_prefix(cfg, params, prompts[1], plain[1][:ss["k"]], P)
        full = _full_batch_vs_golden(cfg, params, watch.full, P) if watch.full else []
        gates, cap, floor = _verify_gates(cfg, ss, prefix, self_run, full, tie_share)
        return dict(prefix, full_batch_vs_golden=full, delta_cap=cap, acceptance_floor=floor,
                    acceptance=self_run["acceptance"], gates=gates)
    verify = verify_checks(runs["self_k4"], watches["self_k4"])
    delta = verify["delta"]

    divergences, streams_ok = [], True
    for i, (got, want) in enumerate(zip(results["greedy_k4"], plain)):
        at = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if at is None:
            streams_ok = streams_ok and len(got) == len(want)
            continue
        gap = gaps.get((rids[i], at), (None,))[0]
        allowed = gap is not None and gap < 2 * delta and verify["gates"]["delta_capped"]
        divergences.append({"prompt": ss["prompts"][i], "at": at, "top2_gap": gap,
                            "allowed": allowed})
        streams_ok = streams_ok and allowed
    checked = watches["self_k4"].checked
    runs["self_k4"]["checked_positions"] = {
        "n": len(checked), "top2_tied": sum(g == 0 for g in checked) / max(len(checked), 1),
        "top2_gap_below_2_delta": sum(g < 2 * delta for g in checked) / max(len(checked), 1)}
    del watches

    # Each planted verify fault in turn: the self-speculation run and the
    # prefix check again, held by the same gates, one of which must fail.
    faults = {}
    for name in ss["verify_faults"]:
        with _VerifyFault(name):
            run, _, watch = serve(cfg, params, SpecConfig(num_draft_tokens=ss["k"]))
            f = verify_checks(run, watch)
        del watch
        faults[name] = dict(f, caught=not all(f["gates"].values()))
    want_launches = dict(calls.want)
    runs_ok = all(r["drained"] and r["lens_ok"] and r["in_vocab"] and not r["failed"]
                  for r in runs.values())
    counts_ok = (launches == want_launches and all(n > 0 for n in launches.values())
                 and runs["greedy_k4"]["pages_trimmed"] > 0)
    verify_ok = all(verify["gates"].values())
    faults_ok = all(f["caught"] for f in faults.values())
    ok = streams_ok and runs_ok and counts_ok and verify_ok and faults_ok
    emit({"phase": "serve_spec", "ok": ok, "model": "gemma2_9b", "layers": L,
          "draft": {"layers": 2, "window_pattern": [4096, None], "params": "views of the "
                    "target's first two layers, its embed, final norm and lm_head"},
          "prompts": list(ss["prompts"]), "max_new": ss["max_new"], "k": ss["k"],
          "runs": runs, "launches": launches, "launches_expected": want_launches,
          "paged_prefill_split_launches": split_launches,
          "verify_calls": calls.verify_calls, "verify": verify,
          "plain_top2_near_tie_share": tie_share, "rel_err_tol": ss["logit_tol"],
          "greedy_streams_equal_plain_to_first_divergence": streams_ok,
          "divergences": divergences, "verify_faults": faults,
          "adaptive_streams_equal_greedy_k4": [a == b for a, b in zip(results["adaptive"],
                                                                      results["greedy_k4"])],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not ok:
        raise AssertionError("serve_spec phase failed its checks")


# Llama-3-8B as configured, trained by SGD on one batch of random tokens.
# lr: a bf16 weight of the 8B init (|w| ~ 0.016, an ulp ~ 1e-4) moves only
# where lr·|g| passes half an ulp; the lm_head's target columns see
# gradients ~ |x| / tokens ~ 5e-4, so lr 0.5 moves them while a step stays
# small against the weights.
def simulate_ring(q, k, v, n, *, int8=False, block_kv=512, on_partial=None, **kw):
    """The ring attention of n ranks driven in one process, no process
    group: q, k, v unsharded [b, h, S, d], cut into n shards; rank idx's
    steps (parallel/ring.ring_step) are fed the K/V block of rank (idx -
    step) mod n, the order the ring's rotation delivers them, and merged as
    the ring merges them (the f32 accumulator, merge_two_partials, the last
    step peeled). Returns the ranks' rows concatenated, bit for bit the
    output of ring_attention[_int8] on n ranks. on_partial(idx, step, o,
    lse) sees each step's partial."""
    import torch
    from quantizedmha_tpu_torch.parallel import ring
    from quantizedmha_tpu_torch.parallel.combine import merge_two_partials
    qs, ks, vs = ([c.contiguous() for c in x.chunk(n, dim=2)] for x in (q, k, v))
    blocks = [ring.quantize_shard(ks[i], vs[i], block_kv) if int8 else (ks[i], vs[i])
              for i in range(n)]
    outs = []
    for idx in range(n):
        partial = ring.ring_step(qs[idx], idx=idx, n=n, kv_shard_len=ks[idx].shape[2],
                                 int8=int8, **{"sm_scale": None, "causal": False,
                                               "window": None, "logit_softcap": None,
                                               "attention_sinks": 0, **kw})
        o = torch.zeros(qs[idx].shape, dtype=torch.float32, device=q.device)
        lse = torch.full(qs[idx].shape[:3], float("-inf"), dtype=torch.float32, device=q.device)
        for step in range(n):
            o_s, lse_s = partial(step, *blocks[(idx - step) % n])
            if on_partial is not None:
                on_partial(idx, step, o_s, lse_s)
            o, lse = merge_two_partials(o, lse, o_s, lse_s)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=2)


def simulate_context_parallel(q, k, v, n, *, seq_len=None, **kw):
    """context_parallel_attention of n ranks in one process: each rank's
    flash partial against its K/V shard at its global offsets, then the
    merge of parallel/combine.merge_partial_attention with the two
    all-reduces as a max and a sum over the ranks in rank order."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import flash_attention
    ks, vs = ([c.contiguous() for c in x.chunk(n, dim=2)] for x in (k, v))
    total = seq_len if seq_len is not None else k.shape[2]
    parts = [flash_attention(q, ks[i], vs[i], save_residuals=True,
                             q_offset=total - q.shape[2], kv_offset=i * ks[i].shape[2], **kw)
             for i in range(n)]
    lse = torch.stack([p[1].float() for p in parts])
    m = lse.amax(dim=0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(torch.where(torch.isfinite(lse), lse - m_safe, torch.full_like(lse, float("-inf"))))
    l_sum, o_sum = w[0], parts[0][0].float() * w[0][..., None]
    for i in range(1, n):
        l_sum = l_sum + w[i]
        o_sum = o_sum + parts[i][0].float() * w[i][..., None]
    l_safe = torch.where(l_sum == 0.0, torch.ones_like(l_sum), l_sum)
    return (o_sum / l_safe[..., None]).to(q.dtype)


# Ring and context parallelism at Llama-3-8B's attention width: 4 ranks'
# steps driven in one process (simulate_ring), 32768 tokens, 8192 a shard;
# the INT8 ring's quant block divides the shard, so its payloads and scales
# are the unsharded ones. The reference workload's INT8 ring runs row 2.
PARALLEL = dict(ranks=4, seq=32768, Hq=32, Hkv=8, D=128, block_kv=512, suffix=2048,
                window=4096, reference=dict(N=8192, h=32, d=32))


def _merge_chain(parts, tols):
    """Partials (o, lse) merged in order as the ring merges them (an f32
    accumulator, merge_two_partials) and the merged output's tolerance
    from theirs (tol_o, tol_lse) through merge_tolerance; a merged lse =
    log(e^la + e^lb) moves by at most w_a d_a + w_b d_b."""
    import torch
    from quantizedmha_tpu_torch.parallel.combine import merge_two_partials
    acc_o, acc_lse = parts[0][0].float(), parts[0][1].float()
    t_o, t_lse = tols[0]
    for (o, lse), (to, tl) in zip(parts[1:], tols[1:]):
        new_o, new_lse = merge_two_partials(acc_o, acc_lse, o, lse)
        t_o = merge_tolerance(new_o, (acc_lse, lse), (acc_o, o), (t_o, to), (t_lse, tl))
        both = torch.logaddexp(acc_lse.double(), lse.double())
        wa, wb = (torch.where(torch.isfinite(both) & torch.isfinite(x),
                              torch.exp(x.double() - both), torch.zeros_like(both))
                  for x in (acc_lse, lse))
        t_lse = wa * t_lse + wb * tl
        acc_o, acc_lse = new_o, new_lse
    return acc_o, acc_lse, t_o


def _visible_keys(q_pos, k0, n_keys, causal):
    """Keys of [k0, k0 + n_keys) that a row at global position q_pos sees."""
    import torch
    if not causal:
        return torch.full_like(q_pos, n_keys)
    return (q_pos - k0 + 1).clamp(0, n_keys)


def _int8_plain(q, k_i8, ks, v_i8, vs, q_offset, kv_offset, *, causal, mode):
    """The INT8 kernel's plain version with its state: (o, lse, l, tol_o,
    tol_lse), the tolerances flash_tolerances gives its kernel."""
    import math
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    block_kv = k_i8.shape[2] // ks.shape[-1]
    offsets = fa8._offsets(q_offset, kv_offset, q.shape[0], q.device)
    acc, m, l = fa8._flash_int8_plain_state(
        q, k_i8, ks, v_i8, vs, offsets, sm_scale=q.shape[-1] ** -0.5, causal=causal,
        kv_len=k_i8.shape[2], block_kv=block_kv, scale_clamp=1e-8, p_scale=127.0,
        window=None, softcap=None, sinks=0, mode=mode)
    o = (acc * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)).to(q.dtype)
    lse = torch.where(l > 0.0, m + torch.log(l) - math.log(127.0),
                      torch.full_like(l, float("-inf")))[..., 0]
    tol_o, tol_lse = flash_tolerances(o, lse, l, v_i8, vs, block_kv, mode)
    return o, lse, l, tol_o, tol_lse


def _float_plain(q, k, v, q_offset, kv_offset, *, causal, window):
    """Row 5's plain version at these offsets: (o, lse, tol_o, tol_lse)."""
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    offsets = fa._offsets(q_offset, kv_offset, q.shape[0], q.device)
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, causal=causal, block_kv=min(1024, k.shape[2]), window=window,
              softcap=None, sinks=0)
    o, lse = fa._flash_fwd_plain(q, k, v, offsets, save_residuals=True, **kw)
    w_abs = fa._flash_fwd_plain(q, k, v.abs(), offsets, save_residuals=False, **kw)
    tol_o, tol_lse = flash_fwd_tolerances(q, k, v, o, lse, w_abs, sm_scale=sm, softcap=None)
    return o, lse, tol_o, tol_lse


def _ring_case(name, q, k, v, *, int8, causal, window=None, block_kv=512):
    """One ring of PARALLEL["ranks"] simulated ranks against its reference,
    the kernel over the unsharded sequence (for INT8, the prequant kernel
    over the unsharded payloads, which the shards' must equal bit for bit).

    Gates: every partial finite in o (lse -inf only where a row sees no
    key of the step's block) and within its kernel tolerance of its plain
    version; the ring within tol_ring (the steps' tolerances merged,
    _merge_chain) of the plain partials merged; the reference within its
    own tolerance tol_ref of its plain version; the ring within 2 (tol_ring
    + tol_ref) + requant of the reference. Each tolerance bounds its
    kernel's distance from the same attention with unrounded P (it adds a
    kernel's and a plain version's), hence the 2; requant bounds P rounded
    against other running maxima: an int8 P is off by at most 0.5 a key
    (0.5 max|v| n / l on each side, n the visible keys), a bf16 P by 2^-8
    relatively, covered by the 2 (float) or 2^-5 max|v| (INT8 bf16 P).
    Returns (result dict, ring output, reference output, gate tolerance)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    from quantizedmha_tpu_torch.parallel import ring
    n, S = PARALLEL["ranks"], q.shape[2]
    shard = S // n
    mode = 1 if q.shape[-1] <= 64 else 0
    counters = ((fa8.FLASH_INT8_P if mode == 0 else fa8.FLASH_BF16_P,) if int8
                else (fa.FLASH_FWD_BF16 if q.dtype == torch.bfloat16 else fa.FLASH_FWD_F32,))
    kw = dict(causal=causal, window=window)
    for c in counters:
        c.reset()
    partials = {}
    t0 = time.perf_counter()
    out = simulate_ring(q, k, v, n, int8=int8, block_kv=block_kv,
                        on_partial=lambda i, s, o, lse: partials.__setitem__((i, s), (o, lse)),
                        **kw)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    launches = counters[0].launches
    qs, ks_, vs_ = ([c.contiguous() for c in x.chunk(n, dim=2)] for x in (q, k, v))
    blocks = [ring.quantize_shard(ks_[i], vs_[i], block_kv) for i in range(n)] if int8 else None
    res = {"name": name, "launches": launches, "launches_expected": n * n,
           "ring_wall_s": ring_s}
    ratios, masked, nonfinite = [], 0, 0
    q_pos_all = torch.arange(S, device=q.device, dtype=torch.float64)
    ring_parts, ring_tol, requant_ring = [], [], []
    for idx in range(n):
        parts, tols, reqs = [], [], []
        q_pos = q_pos_all[idx * shard:(idx + 1) * shard][None, None, :, None]
        for step in range(n):
            src = (idx - step) % n
            o_k, lse_k = partials[(idx, step)]
            nonfinite += int((~torch.isfinite(o_k)).sum()) + int(torch.isnan(lse_k).sum())
            masked += int(bool(torch.isneginf(lse_k).all()))
            if int8:
                o_p, lse_p, l_p, to, tl = _int8_plain(qs[idx], *blocks[src], idx * shard,
                                                      src * shard, causal=causal, mode=mode)
                vmax = _int8_vmax(blocks[src][2], blocks[src][3], q.shape[1])
                if mode == 0:
                    l_d = l_p.double()
                    vis = _visible_keys(q_pos, src * shard, shard, causal)
                    reqs.append(torch.where(l_d > 0, 0.5 * vmax * vis / l_d,
                                            torch.zeros_like(l_d)))
            else:
                o_p, lse_p, to, tl = _float_plain(qs[idx], ks_[src], vs_[src], idx * shard,
                                                  src * shard, **kw)
            ratios.append(max(err_over_tol(o_k, o_p, to), err_over_tol(lse_k, lse_p, tl)))
            parts.append((o_p, lse_p))
            tols.append((to, tl))
        o_m, lse_m, t_m = _merge_chain(parts, tols)
        if reqs:  # each step's bound, weighted as the merge weighs its output
            requant_ring.append(sum(
                torch.where(torch.isfinite(lse_p), torch.exp(lse_p.double() - lse_m.double()),
                            torch.zeros_like(lse_m.double()))[..., None] * r
                for (_, lse_p), r in zip(parts, reqs)))
        if q.dtype == torch.bfloat16:
            t_m = t_m + 2.0**-7 * (o_m.double().abs() + t_m)
        ring_parts.append(o_m.to(q.dtype))
        ring_tol.append(t_m)
    plain_ring = torch.cat(ring_parts, dim=2)
    tol_ring = torch.cat(ring_tol, dim=2)
    # the reference: the kernel over the unsharded sequence, and its plain version
    if int8:
        k_i8, k_sc = quantize_kv_blocks(k, block_kv)
        v_i8, v_sc = quantize_kv_blocks(v, block_kv)
        whole = (k_i8, k_sc, v_i8, v_sc)
        res["payloads_equal_unsharded"] = all(
            torch.equal(torch.cat([b[j] for b in blocks], dim=2), whole[j]) for j in range(4))
        entry = fa8.flash_attention_int8_prequant if mode == 0 else fa8.flash_attention_int8_t_prequant
        ref_kw = {"block_kv": block_kv} if mode == 0 else {}
        t0 = time.perf_counter()
        ref = entry(q, *whole, causal=causal, **ref_kw)
        torch.cuda.synchronize()
        res["unsharded_kernel_wall_s"] = time.perf_counter() - t0
        o_ref_p, _, l_ref, tol_ref, _ = _int8_plain(q, *whole, 0, 0, causal=causal, mode=mode)
        vmax = _int8_vmax(v_i8, v_sc, q.shape[1])
        if mode == 0:
            vis = _visible_keys(q_pos_all[None, None, :, None], 0, S, causal)
            l_d = l_ref.double()
            requant = (torch.where(l_d > 0, 0.5 * vmax * vis / l_d, torch.zeros_like(l_d))
                       + torch.cat(requant_ring, dim=2))
        else:
            requant = 2.0**-5 * vmax
        ref_ratio = err_over_tol(ref, o_ref_p, tol_ref)
    else:
        offsets = fa._offsets(0, 0, q.shape[0], q.device)
        ref, o_ref_p, ref_ratios, tol_ref, _, _ = _flash_fwd_check(q, k, v, offsets,
                                                                   causal=causal, window=window)
        ref_ratio = max(ref_ratios)
        requant = 0.0
    gate = 2.0 * (tol_ring + tol_ref) + requant
    res.update({
        "partials": len(partials), "partials_fully_masked": masked,
        "nonfinite_in_partials": nonfinite,
        "partial_err_over_tol": max(ratios),
        "ring_vs_plain_err_over_tol": err_over_tol(out, plain_ring, tol_ring),
        "reference_err_over_tol": ref_ratio,
        "ring_vs_reference_err_over_tol": err_over_tol(out, ref, gate),
        "max_abs_err_vs_reference": (out.float() - ref.float()).abs().max().item(),
        "tolerance_range": [gate.min().item(), gate.max().item()],
        "ring_tolerance_range": [tol_ring.min().item(), tol_ring.max().item()],
        "output_finite": bool(torch.isfinite(out).all())})
    res["ok"] = (launches == n * n and nonfinite == 0 and res["output_finite"]
                 and max(res["partial_err_over_tol"], res["ring_vs_plain_err_over_tol"],
                         ref_ratio, res["ring_vs_reference_err_over_tol"]) <= 1.0
                 and res.get("payloads_equal_unsharded", True))
    return res, out, ref, gate


def _int8_vmax(v_i8, v_scales, heads):
    """Each q head's max dequantized |v| over its kv head, [1, H, 1, 1]."""
    from quantizedmha_tpu_torch.ops.quantize import dequantize_kv_blocks
    block = v_i8.shape[2] // v_scales.shape[-1]
    vmax = dequantize_kv_blocks(v_i8, v_scales, block).abs().amax(dim=(-2, -1))
    return vmax.repeat_interleave(heads // v_i8.shape[1], dim=1)[:, :, None, None].double()


def _cp_suffix_case(q, k, v):
    """context_parallel_attention of PARALLEL["ranks"] simulated ranks with
    q the sequence's last rows, against row 5 over the unsharded sequence
    (end-aligned), gated as _ring_case gates a ring."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    n, S, Sq = PARALLEL["ranks"], k.shape[2], q.shape[2]
    shard = S // n
    fa.FLASH_FWD_BF16.reset()
    out = simulate_context_parallel(q, k, v, n, causal=True)
    torch.cuda.synchronize()
    launches = fa.FLASH_FWD_BF16.launches
    parts, tols = [], []
    for r in range(n):
        o_p, lse_p, to, tl = _float_plain(q, k[:, :, r * shard:(r + 1) * shard].contiguous(),
                                          v[:, :, r * shard:(r + 1) * shard].contiguous(),
                                          S - Sq, r * shard, causal=True, window=None)
        parts.append((o_p, lse_p))
        tols.append((to, tl))
    o_m, _, t_m = _merge_chain(parts, tols)
    t_m = t_m + 2.0**-7 * (o_m.double().abs() + t_m)
    offsets = fa._offsets(S - Sq, 0, q.shape[0], q.device)
    ref, _, ref_ratios, tol_ref, _, _ = _flash_fwd_check(q, k, v, offsets, causal=True)
    gate = 2.0 * (t_m + tol_ref)
    res = {"name": "context_parallel suffix", "launches": launches, "launches_expected": n,
           "ranks_vs_plain_err_over_tol": err_over_tol(out, o_m.to(q.dtype), t_m),
           "reference_err_over_tol": max(ref_ratios),
           "vs_reference_err_over_tol": err_over_tol(out, ref, gate),
           "max_abs_err_vs_reference": (out.float() - ref.float()).abs().max().item(),
           "tolerance_range": [gate.min().item(), gate.max().item()],
           "output_finite": bool(torch.isfinite(out).all())}
    res["ok"] = (launches == n and res["output_finite"]
                 and max(res["ranks_vs_plain_err_over_tol"], res["reference_err_over_tol"],
                         res["vs_reference_err_over_tol"]) <= 1.0)
    return res


def _single_rank_groups(q, k, v):
    """The public entries on a one-rank NCCL group (a FileStore in the build
    directory): make_mesh((1,), ("cp",)) for ring_attention,
    ring_attention_int8 and context_parallel_attention, a 1 x 1 ("dp",
    "tp") mesh for head_parallel_attention with both kernels. With one rank
    each is one launch of its kernel over the whole sequence and must equal
    that kernel's output bit for bit. The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from quantizedmha_tpu_torch.ops import cuda_lib
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.parallel import (context_parallel_attention,
                                                 head_parallel_attention, make_mesh,
                                                 ring_attention, ring_attention_int8)
    from quantizedmha_tpu_torch.parallel.ring import quantize_shard
    bkv = PARALLEL["block_kv"]
    refs = {"ring_attention": fa.flash_attention(q, k, v, causal=True, save_residuals=True)[0],
            "ring_attention_int8": fa8.flash_attention_int8_prequant(
                q, *quantize_shard(k, v, bkv), block_kv=bkv, causal=True,
                save_residuals=True)[0],
            "head_parallel fa": fa.flash_attention(q, k, v, causal=True),
            "head_parallel fa_int8": fa8.flash_attention_int8(q, k, v, causal=True)}
    refs["context_parallel_attention"] = refs["ring_attention"]
    store = cuda_lib.BUILD_DIR / f"nccl_store_{os.getpid()}"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        group = make_mesh((1,), ("cp",)).get_group("cp")
        mesh = make_mesh((1, 1), ("dp", "tp"))
        for c in (fa.FLASH_FWD_BF16, fa8.FLASH_INT8_P, fa8.FLASH_BF16_P):
            c.reset()
        outs = {"ring_attention": ring_attention(q, k, v, group=group, causal=True),
                "ring_attention_int8": ring_attention_int8(q, k, v, group=group, causal=True,
                                                           block_kv=bkv),
                "context_parallel_attention": context_parallel_attention(
                    q, k, v, group=group, causal=True),
                "head_parallel fa": head_parallel_attention(q, k, v, mesh, causal=True),
                "head_parallel fa_int8": head_parallel_attention(q, k, v, mesh, causal=True,
                                                                 kernel="fa_int8")}
        torch.cuda.synchronize()
        launches = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16.launches,
                    "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches,
                    "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches}
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    equal = {name: torch.equal(outs[name], refs[name]) for name in outs}
    want = {"flash_fwd[bf16]": 3, "flash_int8_fwd[int8_p]": 2, "flash_int8_fwd[bf16_p]": 0}
    return {"bit_equal": equal, "launches": launches, "launches_expected": want,
            "ok": all(equal.values()) and launches == want}


def phase_parallel(st):
    import torch
    from quantizedmha_tpu_torch.parallel import ring
    pr = PARALLEL
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(8)
    shape = lambda h, s, d: (1, h, s, d)  # noqa: E731
    q, k, v = (torch.randn(shape(h, pr["seq"], pr["D"]), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (pr["Hq"], pr["Hkv"], pr["Hkv"]))
    cases, launches = [], {}

    def add(name, n):
        launches[name] = launches.get(name, 0) + n

    res, out, ref, gate = _ring_case("ring_attention causal", q, k, v, int8=False, causal=True)
    cases.append(res)
    add("flash_fwd[bf16]", res["launches"])
    # The planted fault: each step's kv offset from rank idx + step, the
    # blocks still fed in ring order. It must fail the reference gate.
    right = ring.source_rank
    ring.source_rank = lambda idx, step, n: (idx + step) % n
    try:
        bad = simulate_ring(q, k, v, pr["ranks"], causal=True)
    finally:
        ring.source_rank = right
    fault = {"planted": "source rank idx + step (wrong kv offsets)",
             "ring_vs_reference_err_over_tol": err_over_tol(bad, ref, gate)}
    fault["caught"] = fault["ring_vs_reference_err_over_tol"] > 1.0
    print(f"chip_smoke parallel: planted fault ({fault['planted']}) "
          f"{'caught' if fault['caught'] else 'NOT caught'}: err/tol "
          f"{fault['ring_vs_reference_err_over_tol']:.3g}", flush=True)
    del out, ref, gate, bad
    res = _ring_case("ring_attention window 4096", q, k, v, int8=False, causal=True,
                     window=pr["window"])[0]
    cases.append(res)
    add("flash_fwd[bf16]", res["launches"])
    res = _ring_case("ring_attention_int8 causal", q, k, v, int8=True, causal=True,
                     block_kv=pr["block_kv"])[0]
    cases.append(res)
    add("flash_int8_fwd[int8_p]", res["launches"])
    res = _cp_suffix_case(q[:, :, -pr["suffix"]:].contiguous(), k, v)
    cases.append(res)
    add("flash_fwd[bf16]", res["launches"])
    single = _single_rank_groups(q, k, v)
    for name, n in single["launches"].items():
        add(name, n)
    del q, k, v
    torch.cuda.empty_cache()
    rw = pr["reference"]
    for causal in (False, True):
        qr, kr, vr = (torch.randn((1, rw["h"], rw["N"], rw["d"]), generator=g, device="cuda")
                      for _ in range(3))
        res = _ring_case(f"ring_attention_int8 reference workload causal={causal}",
                         qr, kr, vr, int8=True, causal=causal, block_kv=pr["block_kv"])[0]
        cases.append(res)
        add("flash_int8_fwd[bf16_p]", res["launches"])
    for name, n in launches.items():
        st["launches"][name] = st["launches"].get(name, 0) + n
    ok = all(c["ok"] for c in cases) and single["ok"] and fault["caught"]
    emit({"phase": "parallel", "ok": ok, "ranks_simulated": pr["ranks"], "shape": {
              "B": 1, "Hq": pr["Hq"], "Hkv": pr["Hkv"], "S": pr["seq"], "D": pr["D"],
              "dtype": "bfloat16", "shard": pr["seq"] // pr["ranks"]},
          "cases": cases, "single_rank_nccl": single, "planted_fault": fault,
          "launches": launches,
          "not_checked": "the rotation over NCCL between cards (the script needs one card): the "
                         "simulated ranks check the ring's arithmetic, the one-rank "
                         "group the entries' wiring",
          "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("parallel phase failed its checks")


# --- Tensor and context parallelism: ranks as processes on the one card -----
#
# NCCL refuses two ranks on one GPU, so serve_tp and serve_cp spawn their
# ranks as processes that share GPU 0, joined by a gloo group through a
# FileStore in a temporary directory (gloo moves CUDA tensors in all_reduce
# and all_gather; a ring's send / recv goes through host buffers:
# parallel/ring.py). N processes time-share the card and every collective
# crosses the host, so their times are not multi-GPU speeds. The mesh's
# device type only places DTensors, which these paths do not use: its groups
# are the default group's gloo.

SERVE_TP = dict(tp=4, batch=8, prompt_len=256, max_new=32, chunk=8, page=128, block_kv=256,
                seed=0, fault_layers=2, timeout_s=900,
                spec=dict(requests=4, max_new=32, k=4, draft_layers=2, temperature=0.8,
                          top_p=0.95, seed=7),
                # Llama-3-70B's layer dims (JAX tests/test_sharded_serving.py:308):
                # hidden 8192, 64 / 8 heads, head_dim 128 at tp=8 -> 8 q / 1 kv
                # head a rank; depth cut to 2 layers, the MLP to 2048 and the
                # vocabulary to 512 (as that test does); f32, as that test
                # runs, so the streams hold to the unsharded engine's.
                wide=dict(tp=8, layers=2, hidden=8192, heads=64, kv_heads=8, head_dim=128,
                          intermediate=2048, vocab=512, prompts=((1, 2, 3, 4, 5), (7, 8, 9)),
                          max_new=4, page=16, timeout_s=600))
SERVE_CP = dict(cp=4, prompts=(7900, 2000), buckets=(2048, 8192), max_new=16, page=128,
                seed=0, timeout_s=600)


def _serve_params_lazy(cfg, seed, *, keep_layers=None, device="cuda"):
    """serve's weights made on demand (serving.sharded.LayerStack / Lazy):
    the numbers of quantize_llama_params(init_params(cfg, seed), bits=8), an
    INT8 (w8a16) layer stack and a float lm_head, drawn in init_params's
    order (each matmul weight's layers in turn, then embed, then lm_head),
    so a rank that keeps a shard never holds the whole model. keep_layers:
    the first layers only (a draft cut from the model; the rest are drawn
    and dropped, so the later draws stay in step)."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import quantize_weight
    from quantizedmha_tpu_torch.serving.sharded import LayerStack, Lazy
    gen = torch.Generator(device=device).manual_seed(seed)
    L, h, hd, dt = cfg.num_layers, cfg.hidden_size, cfg.hd, cfg.dtype
    keep = L if keep_layers is None else keep_layers

    def draw(shape, scale=None):
        scale = scale if scale is not None else shape[0] ** -0.5
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)

    def stack(shape):
        def make(i):
            w = quantize_weight(draw(shape))
            if i == keep - 1:
                for _ in range(keep, L):
                    draw(shape)
            return w
        return LayerStack(keep, make)

    def ones(*shape):
        return Lazy(lambda: torch.ones(shape, dtype=dt, device=device))
    layers = dict(attn_norm=ones(keep, h), wq=stack((h, cfg.num_heads * hd)),
                  wk=stack((h, cfg.num_kv_heads * hd)), wv=stack((h, cfg.num_kv_heads * hd)),
                  wo=stack((cfg.num_heads * hd, h)), mlp_norm=ones(keep, h),
                  w_gate=stack((h, cfg.intermediate_size)),
                  w_up=stack((h, cfg.intermediate_size)),
                  w_down=stack((cfg.intermediate_size, h)))
    return dict(layers=layers, embed=Lazy(lambda: draw((cfg.vocab_size, h), 0.02)),
                final_norm=ones(h), lm_head=Lazy(lambda: draw((h, cfg.vocab_size))))


def _tp_plan_bytes(cfg, tp):
    """A rank's parameter bytes by the sharding plan, sized from the
    abstract parameters (meta tensors: nothing is allocated): replicated
    leaves whole, sharded leaves / tp."""
    from quantizedmha_tpu_torch.models.llama import init_params
    from quantizedmha_tpu_torch.quant.weights import quantize_llama_params, weight_bytes
    from quantizedmha_tpu_torch.serving.sharded import shard_params, tp_param_specs
    abstract = quantize_llama_params(init_params(cfg, device="meta"), bits=8)
    return weight_bytes(shard_params(abstract, tp_param_specs(), (0, tp)))


def _rank_main(rank, world, store, out_dir, jobs):
    """One rank: the default group on gloo over GPU 0, each job in turn, the
    results (host tensors) saved for the parent."""
    import torch
    import torch.distributed as dist
    if torch.cuda.is_available():  # (a CPU rehearsal has none)
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        out = {job["name"]: _RANK_JOBS[job["kind"]](rank, job) for job in jobs}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(jobs, world, timeout_s):
    """Run `jobs` on `world` spawned ranks; each rank's results, in rank
    order. A rank that raises (its traceback in the exception), exits
    non-zero or outlives timeout_s fails the call; every rank is stopped
    before this returns."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_rank_main, args=(world, os.path.join(d, "store"), d, jobs),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a rank of {world} ran past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


class _Capture:
    """While active: the logits of every prefill_at / prefill_cp_at call and
    the operands of the last call of the adapter's attention functions
    (the model's `_attention`, paged decode and paged prefill), for holding
    each kernel against its plain version at this rank's shapes."""

    NAMES = ("prefill_at", "prefill_cp_at", "_attention", "paged_decode_attention",
             "paged_prefill_attention")

    def __init__(self):
        self.prefill_logits, self.last = [], {}

    def __enter__(self):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        self.saved = {n: getattr(la, n) for n in self.NAMES}

        def prefill(name):
            fn = self.saved[name]

            def call(*a, **kw):
                out = fn(*a, **kw)
                self.prefill_logits.append(out[0].float().cpu())
                return out
            return call

        def keep(name):
            fn = self.saved[name]

            def call(*a, **kw):
                self.last[name] = (a, kw)
                return fn(*a, **kw)
            return call
        la.prefill_at, la.prefill_cp_at = prefill("prefill_at"), prefill("prefill_cp_at")
        for n in self.NAMES[2:]:
            setattr(la, n, keep(n))
        return self

    def __exit__(self, *exc):
        from quantizedmha_tpu_torch.serving import llama_adapter as la
        for n, fn in self.saved.items():
            setattr(la, n, fn)


def _decode_call_check(call):
    """A captured paged_decode_attention call's kernel against its plain
    version (_decode_check): err/tol and the (Hq, Hkv) it ran at."""
    (q, kp, vp, ks, vs, lengths, tables), kw = call
    layer = kw["layer"]
    operands = (q, kp[layer], vp[layer], ks[layer], vs[layer], lengths, tables)
    sm = kw.get("sm_scale") or q.shape[-1] ** -0.5
    ratio = _decode_check(operands, dict(sm_scale=sm, window=kw.get("window"),
                                         softcap=kw.get("logit_softcap"),
                                         sinks=kw.get("attention_sinks", 0),
                                         save_residuals=False))[2]
    return {"err_over_tol": ratio, "Hq": q.shape[1], "Hkv": kp.shape[1], "B": q.shape[0]}


def _tp_stats(eng, records, t_run, steps, run_from=0):
    """What every TP rank reports of a run: parameter and cache shapes and
    bytes, the audit (every record), the host time inside the all-reduces of
    the timed part (records[run_from:], t_run seconds, `steps` decode
    steps) and decode ms a step."""
    import torch
    from quantizedmha_tpu_torch.profiling.collectives import audit_events
    from quantizedmha_tpu_torch.quant.weights import weight_bytes
    rep = audit_events(records)
    ar_s = sum(r.seconds for r in records[run_from:] if r.kind == "all-reduce")
    return {"param_bytes": weight_bytes(eng.params), "kv_heads": eng.acfg.num_kv_heads,
            "audit": {"counts": rep.counts, "bytes": rep.bytes_by_kind,
                      "dtypes": sorted({r.dtype for r in records}),
                      "groups": sorted({r.ranks for r in records})},
            "all_reduce_s": ar_s, "run_s": t_run,
            "decode_ms_per_step": t_run * 1e3 / max(steps, 1),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _drained(eng, allocs) -> bool:
    return all(not a.tables and a.free_pages == a.num_pages - 1 for a in allocs)


def _rank_tp_serve(rank, job):
    """TPEngine on serve's model and traffic (job["cfg"] sets the depth):
    a warm-up request, then the measured run (launches zeroed before it, read
    after; its collectives recorded), then a fresh request's TTFT. A
    planted fault permutes two heads of each rank's wo rows."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.parallel import make_mesh, record_collectives
    from quantizedmha_tpu_torch.serving.sharded import TPEngine
    cfg, ecfg, tp, dev = job["cfg"], job["ecfg"], job["tp"], job.get("device", "cuda")
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((tp,), ("tp",), device_type="cpu")
    t0 = time.perf_counter()
    eng = TPEngine(cfg, _serve_params_lazy(cfg, job["seed"], device=dev), ecfg, mesh,
                   device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if job.get("fault") == "wo head order":
        wo = eng.params["layers"]["wo"].values  # [L, in / tp, out], rows head-major
        hd = cfg.hd
        wo[:, :2 * hd] = torch.cat([wo[:, hd:2 * hd], wo[:, :hd]], dim=1).clone()
    # A warm-up prefill outside the measured run (first kernel and cuBLAS
    # use); its one token ends it at admission, with no decode chunk.
    eng.add_request(job["prompts"][0][:100], max_new=1)
    eng.run()
    eng.finished.clear()
    kernels = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P, "paged_decode": dec.PAGED_DECODE}
    for k in kernels.values():
        k.reset()
    admitted0 = eng.metrics.counter("requests_admitted")
    steps0 = eng.metrics.counter("decode_steps")
    with _Capture() as cap, record_collectives() as records:
        rids = [eng.add_request(p, max_new=job["max_new"]) for p in job["prompts"]]
        t0 = time.perf_counter()
        eng.step()
        first_step_s = time.perf_counter() - t0
        sd0 = eng.metrics.counter("decode_steps")
        run_from = len(records)
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    admitted = eng.metrics.counter("requests_admitted") - admitted0
    steps = eng.metrics.counter("decode_steps") - steps0
    out = {"streams": [results[r] for r in rids], "launches": launches,
           "admitted": admitted, "decode_steps": steps, "build_s": build_s,
           "first_step_s": first_step_s, "failed": dict(eng.failed),
           "drained": _drained(eng, eng._each_alloc()),
           **_tp_stats(eng, records, t_run, eng.metrics.counter("decode_steps") - sd0,
                       run_from)}
    if rank == 0:
        out["prefill_logits"] = torch.cat(cap.prefill_logits)
        if job.get("kernels"):
            q, k, v = cap.last["_attention"][0][1:4]
            e = _flash_case("tp", 0, q, k, v, job["block_kv"], True, replaces=None,
                            library=False, timed=False)
            out["row1"] = {"err_over_tol": e["err_over_tol"], "same_bits_twice":
                           e["same_bits_twice"], "Hq": q.shape[1], "Hkv": k.shape[1],
                           "S": q.shape[2]}
            out["row3"] = _decode_call_check(cap.last["paged_decode_attention"])
    if job.get("kernels"):
        before = eng.metrics.counter("tokens_generated")
        t0 = time.perf_counter()
        eng.add_request(job["prompts"][1], max_new=job["max_new"])
        while eng.metrics.counter("tokens_generated") == before and (eng.queue or eng.active):
            eng.step()
        out["ttft_s"] = time.perf_counter() - t0
        eng.run()
    del eng
    torch.cuda.empty_cache()
    return out


def _rank_tp_spec(rank, job):
    """TPSpecDecodeEngine on serve's model, its draft the first layers (drawn
    in step with the target's, so the same numbers): one run a sampling
    setting, each on a fresh engine; row 10 held at verify's shape."""
    import dataclasses as dc
    import torch
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.parallel import make_mesh
    from quantizedmha_tpu_torch.serving.sampling import SamplingParams
    from quantizedmha_tpu_torch.serving.sharded import TPSpecDecodeEngine
    from quantizedmha_tpu_torch.serving.speculative import SpecConfig
    cfg, tp, sp, dev = job["cfg"], job["tp"], job["spec"], job.get("device", "cuda")
    dcfg = dc.replace(cfg, num_layers=sp["draft_layers"])
    mesh = make_mesh((tp,), ("tp",), device_type="cpu")
    runs = {}
    for label, sampling in (("greedy", SamplingParams()),
                            ("sampled", SamplingParams(temperature=sp["temperature"],
                                                       top_p=sp["top_p"], seed=sp["seed"]))):
        ecfg = dc.replace(job["ecfg"], sampling=sampling)
        eng = TPSpecDecodeEngine(cfg, _serve_params_lazy(cfg, job["seed"], device=dev), dcfg,
                                 _serve_params_lazy(cfg, job["seed"], device=dev,
                                                    keep_layers=sp["draft_layers"]),
                                 ecfg, mesh, SpecConfig(num_draft_tokens=sp["k"]),
                                 device=dev)
        pp.PAGED_PREFILL.reset()
        with _Capture() as cap:
            t0 = time.perf_counter()
            rids = [eng.add_request(p, max_new=sp["max_new"]) for p in job["prompts"]]
            results = eng.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        rounds = eng.metrics.counter("spec_rounds")
        r = {"streams": [results[i] for i in rids], "rounds": rounds,
             "acceptance": eng.acceptance_rate, "run_s": run_s,
             "tokens_s": sum(len(results[i]) for i in rids) / run_s,
             "paged_prefill": pp.PAGED_PREFILL.launches,
             "paged_prefill_expected": cfg.num_layers * rounds,
             "drained": _drained(eng, eng._each_alloc() + eng._each_alloc(eng._draft_pools()))}
        if rank == 0 and label == "greedy":
            a, kw = cap.last["paged_prefill_attention"]
            q, kp, vp, ks, vs, lengths, q_starts, tables = a
            ratios = _paged_prefill_check(q, (kp, vp, ks, vs), lengths, q_starts, tables)[2]
            r["row10"] = {"err_over_tol": max(ratios), "B": q.shape[0], "Hq": q.shape[1],
                          "Hkv": kp.shape[0], "rows": q.shape[2]}
        runs[label] = r
        del eng
        torch.cuda.empty_cache()
    return runs


def _rank_tp_wide(rank, job):
    """TPEngine at tp=8 on Llama-3-70B's layer dims: each rank's streams,
    the decode kernel's launches and shape (8 q / 1 kv head: row 4), held
    against its plain version; parameter bytes and kv heads."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.parallel import make_mesh, record_collectives
    from quantizedmha_tpu_torch.serving.sharded import TPEngine
    cfg, ecfg, tp, dev = job["cfg"], job["ecfg"], job["tp"], job.get("device", "cuda")
    eng = TPEngine(cfg, _serve_params_lazy(cfg, job["seed"], device=dev), ecfg,
                   make_mesh((tp,), ("tp",), device_type="cpu"), device=dev)
    dec.PAGED_DECODE.reset()
    with _Capture() as cap, record_collectives() as records:
        rids = [eng.add_request(list(p), max_new=job["max_new"]) for p in job["prompts"]]
        t0 = time.perf_counter()
        results = eng.run()
        run_s = time.perf_counter() - t0
    out = {"streams": [results[r] for r in rids], "paged_decode": dec.PAGED_DECODE.launches,
           "paged_decode_expected": cfg.num_layers * eng.metrics.counter("decode_steps"),
           "drained": _drained(eng, eng._each_alloc()),
           **_tp_stats(eng, records, run_s, eng.metrics.counter("decode_steps"))}
    if rank == 0:
        out["row4"] = _decode_call_check(cap.last["paged_decode_attention"])
    return out


def _rank_cp_serve(rank, job):
    """The engine with cp_mesh over every rank, parameters replicated (made
    layer by layer): both prompts, the launches and collectives of the run,
    rank 0's prefill logits and layers 0 / L-1 of its gathered K/V, each
    rank's first ring step held against its plain version; then the planted
    fault (rank-local RoPE positions) on one CP prefill of the short prompt."""
    import dataclasses as dc
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.parallel import make_mesh, record_collectives
    from quantizedmha_tpu_torch.parallel import ring
    from quantizedmha_tpu_torch.serving import llama_adapter as la
    from quantizedmha_tpu_torch.serving.engine import Engine
    from quantizedmha_tpu_torch.serving.sharded import shard_params, tp_param_specs
    cfg, n, dev = job["cfg"], job["cp"], job.get("device", "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = shard_params(_serve_params_lazy(cfg, job["seed"], device=dev), tp_param_specs(),
                          (0, 1))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mesh = make_mesh((n,), ("cp",), device_type="cpu")
    eng = Engine(cfg, params, dc.replace(job["ecfg"], cp_mesh=mesh), device=dev)
    kv_keep = {}
    first_step = {}
    real_cp = la.prefill_cp_at
    real_flash = ring.flash_attention

    def cp_kept(*a, **kw):
        logits, k_all, v_all = real_cp(*a, **kw)
        if rank == 0:
            kv_keep[len(kv_keep)] = [x[[0, -1]].cpu() for x in (k_all, v_all)]
        return logits, k_all, v_all

    def flash_kept(q, k, v, **kw):
        first_step.setdefault("call", (q, k, v, kw))
        return real_flash(q, k, v, **kw)
    for c in (fa.FLASH_FWD_BF16, dec.PAGED_DECODE):
        c.reset()
    la.prefill_cp_at, ring.flash_attention = cp_kept, flash_kept
    ttft = []
    try:
        with _Capture() as cap, record_collectives() as records:
            rids = []
            for p in job["prompts"]:
                t0 = time.perf_counter()
                rids.append(eng.add_request(p, max_new=job["max_new"]))
                eng.step()  # its admission (the CP prefill) and a decode step
                torch.cuda.synchronize()
                ttft.append(time.perf_counter() - t0)
            steps0 = eng.metrics.counter("decode_steps")
            t0 = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
    finally:
        la.prefill_cp_at, ring.flash_attention = real_cp, real_flash
    steps = eng.metrics.counter("decode_steps")
    launches = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16.launches,
                "paged_decode": dec.PAGED_DECODE.launches}
    q, k, v, kw = first_step["call"]
    offsets = fa._offsets(kw["q_offset"], kw["kv_offset"], q.shape[0], q.device)
    ratios = _flash_fwd_check(q, k, v, offsets, causal=True)[2]
    from quantizedmha_tpu_torch.profiling.collectives import audit_events
    rep = audit_events(records)
    out = {"streams": [results[r] for r in rids], "launches": launches, "decode_steps": steps,
           "steps_after_admission": steps - steps0, "build_s": build_s, "ttft_s": ttft,
           "decode_ms_per_step": decode_s * 1e3 / max(steps - steps0, 1),
           "audit": {"counts": rep.counts, "bytes": rep.bytes_by_kind,
                     "gather_s": sum(r.seconds for r in records if r.kind == "all-gather")},
           "row5": {"err_over_tol": max(ratios), "Hq": q.shape[1], "Hkv": k.shape[1],
                    "rows": q.shape[2], "keys": k.shape[2], "q_offset": kw["q_offset"],
                    "kv_offset": kw["kv_offset"]},
           "drained": _drained(eng, eng._each_alloc()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        out["prefill_logits"] = torch.cat(cap.prefill_logits)
        out["kv_layers"] = kv_keep
    # The planted fault: rank-local positions in RoPE, one CP prefill.
    short, b = job["fault_prompt"], job["bucket_short"]
    toks = torch.zeros((1, b), dtype=torch.int32, device=dev)
    toks[0, :len(short)] = torch.tensor(short, dtype=torch.int32)
    shard = b // n
    real_pos = la._cp_positions
    la._cp_positions = lambda idx, n_shard, device: torch.arange(n_shard, device=device)
    try:
        bad, _, _ = la.prefill_cp_at(cfg, params, toks[:, rank * shard:(rank + 1) * shard],
                                     len(short) - 1, group=eng.cp_group)
    finally:
        la._cp_positions = real_pos
    if rank == 0:
        out["fault_logits"] = bad.float().cpu()
    del eng, params
    torch.cuda.empty_cache()
    return out


_RANK_JOBS = {"tp_serve": _rank_tp_serve, "tp_spec": _rank_tp_spec, "tp_wide": _rank_tp_wide,
              "cp_serve": _rank_cp_serve}


def _rel(a, ref) -> float:
    """max |a - ref| / std(ref): the serve phases' logit distance."""
    return ((a.float() - ref.float()).abs().max() / ref.float().std()).item()


def _tp_reference(cfg, ecfg, prompts, max_new, seed, *, warm=True, device="cuda"):
    """The unsharded engine on the same weights and traffic (serve's, the
    same warm-up first): its streams, each prompt's prefill logits, the
    top-2 logit gap behind every token it chose, and the golden (the
    reference-attention model's last-token logits of each prompt)."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.quant.weights import quantize_llama_params
    from quantizedmha_tpu_torch.serving import llama_adapter as la
    from quantizedmha_tpu_torch.serving.engine import Engine
    gen = torch.Generator(device=device).manual_seed(seed)
    params = quantize_llama_params(llama.init_params(cfg, gen, device=device), bits=8)
    torch.cuda.empty_cache()
    eng = Engine(cfg, params, ecfg, device=device)
    if warm:
        eng.add_request(list(prompts[0][:100]), max_new=1)
        eng.run()
        eng.finished.clear()

    def gap(logits):
        top = logits.float().topk(2, dim=-1).values
        return (top[..., 0] - top[..., 1]).cpu()
    gaps, real_step = [], la.decode_step

    def step(*a, **kw):
        logits, cache = real_step(*a, **kw)
        gaps.append(gap(logits))
        return logits, cache
    la.decode_step = step
    try:
        with _Capture() as cap:
            rids = [eng.add_request(list(p), max_new=max_new) for p in prompts]
            results = eng.run()
    finally:
        la.decode_step = real_step
    pre = torch.cat(cap.prefill_logits)
    # token 0 of request i comes from its prefill, token j > 0 from decode
    # step j - 1 at lane i (every request stays active to the end).
    tok_gaps = [[gap(pre[i]).item()] + [g[i].item() for g in gaps[:max_new - 1]]
                for i in range(len(prompts))]
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    golden = torch.cat([llama.forward(ref_cfg, params, torch.tensor(
        [list(p)], dtype=torch.int32, device=device))[:, -1].float().cpu() for p in prompts])
    out = {"streams": [results[r] for r in rids], "prefill_logits": pre, "gaps": tok_gaps,
           "golden": golden}
    del eng, params
    torch.cuda.empty_cache()
    return out


def _stream_gate(got, want, gaps, delta):
    """Streams equal up to a first divergence, allowed only where the
    unsharded engine's top-2 gap is below twice the logit delta (serve_spec's
    rule): (ok, [(request, first divergence, gap) ...])."""
    div = []
    for i, (g, w) in enumerate(zip(got, want)):
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None and len(g) != len(w):
            j = min(len(g), len(w))
        if j is not None:
            div.append((i, j, gaps[i][j] if j < len(gaps[i]) else None))
    return all(gp is not None and gp < 2 * delta for _, _, gp in div), div


def _tp_gates(ranks, ref, *, want_launch, want_ar, plan_bytes, kv_heads, golden_tol=0.25):
    """serve_tp (a)'s gates over every rank's results; {gate: bool} and the
    figures they read."""
    r0 = ranks[0]
    delta = (r0["prefill_logits"] - ref["prefill_logits"]).abs().max().item()
    streams_ok, div = _stream_gate(r0["streams"], ref["streams"], ref["gaps"], delta)
    n = len(ref["golden"])
    golden_rel = [_rel(r0["prefill_logits"][i], ref["golden"][i]) for i in range(n)]
    unsharded_rel = [_rel(r0["prefill_logits"][i], ref["prefill_logits"][i]) for i in range(n)]
    gates = {
        "ranks_bit_equal": all(r["streams"] == r0["streams"] for r in ranks),
        # the delta that the stream gate allows divergences by, itself held
        # to the logits' criterion against the unsharded engine's
        "logits_vs_unsharded": max(unsharded_rel) <= golden_tol,
        "streams_vs_unsharded": streams_ok,
        "logits_vs_golden": max(golden_rel) <= golden_tol,
        "launches": all(r["launches"] == want_launch(r) for r in ranks),
        "audit": all(r["audit"]["counts"] == {"all-reduce": want_ar(r)[0]}
                     and r["audit"]["bytes"] == {"all-reduce": want_ar(r)[1]} for r in ranks),
        "param_bytes": all(r["param_bytes"] == plan_bytes for r in ranks),
        "kv_heads": all(r["kv_heads"] == kv_heads for r in ranks),
        "drained": all(r["drained"] and not r["failed"] for r in ranks),
    }
    return gates, {"logit_delta_vs_unsharded": delta, "unsharded_rel_max": max(unsharded_rel),
                   "divergences": div, "golden_rel_max": max(golden_rel),
                   "golden_tol": golden_tol}


def phase_serve_tp(st):
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.serving.engine import EngineConfig
    from quantizedmha_tpu_torch.serving.sharded import local_config
    c = SERVE_TP
    tp, dev = c["tp"], st.get("device", "cuda")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attention_impl="flash_int8")
    batch, plen, max_new, chunk, page = (c[k] for k in ("batch", "prompt_len", "max_new",
                                                         "chunk", "page"))
    mpps = -(-(plen + max_new + chunk + 1) // page)
    ecfg = EngineConfig(num_pages=batch * mpps + 2, page_size=page, max_batch=batch,
                        max_pages_per_seq=mpps, prefill_buckets=(plen,),
                        max_new_tokens=max_new, decode_chunk=chunk)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, plen).tolist() for _ in range(batch)]
    cfg2 = dataclasses.replace(cfg, num_layers=c["fault_layers"])
    w = c["wide"]
    wcfg = llama.LlamaConfig(vocab_size=w["vocab"], hidden_size=w["hidden"],
                             intermediate_size=w["intermediate"], num_layers=w["layers"],
                             num_heads=w["heads"], num_kv_heads=w["kv_heads"],
                             head_dim=w["head_dim"], dtype=torch.float32,
                             attention_impl="flash_int8")
    wecfg = EngineConfig(num_pages=16, page_size=w["page"], max_batch=2, max_pages_per_seq=2,
                         prefill_buckets=(w["page"],), max_new_tokens=w["max_new"],
                         decode_chunk=w["max_new"])
    s = c["spec"]
    smpps = -(-(plen + s["max_new"] + s["k"] + 1) // page)
    secfg = EngineConfig(num_pages=s["requests"] * smpps + 2, page_size=page,
                         max_batch=s["requests"], max_pages_per_seq=smpps,
                         prefill_buckets=(plen,), max_new_tokens=s["max_new"])

    # The unsharded side first, on the same weights (made from serve's seed),
    # then freed: the ranks need the card.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = _tp_reference(cfg, ecfg, prompts, max_new, c["seed"], device=dev)
    ref2 = _tp_reference(cfg2, ecfg, prompts, max_new, c["seed"], device=dev)
    wref = _tp_reference(wcfg, wecfg, w["prompts"], w["max_new"], c["seed"], warm=False,
                         device=dev)
    ref_s = time.perf_counter() - t0
    serve_streams = st.get("serve_streams")

    base = dict(tp=tp, ecfg=ecfg, prompts=prompts, max_new=max_new, seed=c["seed"],
                block_kv=c["block_kv"], device=dev)
    jobs = [dict(base, name="a", kind="tp_serve", cfg=cfg, kernels=True),
            dict(base, name="clean2", kind="tp_serve", cfg=cfg2),
            dict(base, name="fault2", kind="tp_serve", cfg=cfg2, fault="wo head order"),
            dict(base, name="b", kind="tp_spec", cfg=cfg, ecfg=secfg,
                 prompts=prompts[:s["requests"]], spec=s)]
    t0 = time.perf_counter()
    ranks = _spawn_ranks(jobs, tp, c["timeout_s"])
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = _spawn_ranks([dict(name="c", kind="tp_wide", cfg=wcfg, ecfg=wecfg, tp=w["tp"],
                              prompts=w["prompts"], max_new=w["max_new"], seed=c["seed"],
                              device=dev)],
                        w["tp"], w["timeout_s"])
    wide_s = time.perf_counter() - t0

    def gates_for(name, gcfg, gref):
        rs = [r[name] for r in ranks]
        L, hid = gcfg.num_layers, gcfg.hidden_size
        want_launch = lambda r: {"flash_int8_fwd[int8_p]": L * r["admitted"],  # noqa: E731
                                 "flash_int8_fwd[bf16_p]": 0,
                                 "paged_decode": L * r["decode_steps"]}
        size = torch.empty((), dtype=gcfg.dtype).element_size()
        want_ar = lambda r: (2 * L * (r["admitted"] + r["decode_steps"]),  # noqa: E731
                             2 * L * hid * size * (r["admitted"] * plen
                                                   + r["decode_steps"] * batch))
        return _tp_gates(rs, gref, want_launch=want_launch, want_ar=want_ar,
                         plan_bytes=_tp_plan_bytes(gcfg, tp),
                         kv_heads=local_config(gcfg, tp).num_kv_heads)
    a_gates, a_figs = gates_for("a", cfg, ref)
    c2_gates, c2_figs = gates_for("clean2", cfg2, ref2)
    f_gates, f_figs = gates_for("fault2", cfg2, ref2)
    r0 = ranks[0]["a"]
    kernel_ok = (r0["row1"]["err_over_tol"] <= 1 and r0["row1"]["same_bits_twice"]
                 and r0["row3"]["err_over_tol"] <= 1 and r0["row3"]["Hkv"] == 2)
    fault = {"planted": "wo rows of two heads swapped on every rank (head order unlike wq's)",
             "failed_gates": sorted(g for g, ok in f_gates.items() if not ok), **f_figs}
    fault["caught"] = bool(fault["failed_gates"])

    spec = {}
    for label in ("greedy", "sampled"):
        rs = [r["b"][label] for r in ranks]
        spec[label] = {
            "ranks_bit_equal": all(x["streams"] == rs[0]["streams"] for x in rs),
            "row10_launches": all(x["paged_prefill"] == x["paged_prefill_expected"] > 0
                                  for x in rs),
            "drained": all(x["drained"] for x in rs),
            "tokens_each": sorted({len(t) for t in rs[0]["streams"]}),
            "acceptance": rs[0]["acceptance"], "rounds": rs[0]["rounds"],
            "tokens_s": rs[0]["tokens_s"], "run_s": rs[0]["run_s"]}
    row10 = ranks[0]["b"]["greedy"]["row10"]
    spec_ok = (all(v["ranks_bit_equal"] and v["row10_launches"] and v["drained"]
                   and v["tokens_each"] == [s["max_new"]] for v in spec.values())
               and row10["err_over_tol"] <= 1 and row10["Hkv"] == 2)

    wr = [r["c"] for r in wide]
    wplan = _tp_plan_bytes(wcfg, w["tp"])
    wide_res = {
        "ranks_bit_equal": all(x["streams"] == wr[0]["streams"] for x in wr),
        "streams_vs_unsharded": wr[0]["streams"] == wref["streams"],
        "row4_launches": all(x["paged_decode"] == x["paged_decode_expected"] > 0 for x in wr),
        "param_bytes": all(x["param_bytes"] == wplan for x in wr),
        "kv_heads": all(x["kv_heads"] == 1 for x in wr),
        "drained": all(x["drained"] for x in wr),
        "row4": wr[0]["row4"]}
    wide_ok = (all(v for k, v in wide_res.items() if k != "row4")
               and wr[0]["row4"]["err_over_tol"] <= 1 and wr[0]["row4"]["Hkv"] == 1
               and wr[0]["row4"]["Hq"] == 8)

    ra = [r["a"] for r in ranks]
    launches = {"flash_int8_fwd[int8_p]": ra[0]["launches"]["flash_int8_fwd[int8_p]"],
                "paged_decode": ra[0]["launches"]["paged_decode"] + wr[0]["paged_decode"],
                "paged_prefill": ranks[0]["b"]["greedy"]["paged_prefill"]
                + ranks[0]["b"]["sampled"]["paged_prefill"]}
    for name, n in launches.items():
        st["launches"][name] = st["launches"].get(name, 0) + n
    st["launches_mqa"] = st.get("launches_mqa", 0) + wr[0]["paged_decode"]
    st["tp_shapes"] = {"flash_int8_fwd[int8_p]": r0["row1"], "paged_decode": r0["row3"],
                       "paged_prefill": row10}
    ok = (all(a_gates.values()) and all(c2_gates.values()) and fault["caught"] and kernel_ok
          and spec_ok and wide_ok)
    print(f"chip_smoke serve_tp: planted fault ({fault['planted']}) "
          f"{'caught by ' + ', '.join(fault['failed_gates']) if fault['caught'] else 'NOT caught'}",
          flush=True)
    emit({"phase": "serve_tp", "ok": ok, "model": "llama3_8b", "layers": cfg.num_layers,
          "tp": tp, "transport": f"{tp} processes time-sharing one card, gloo through the host",
          "gates": a_gates, **a_figs, "clean_2_layers": c2_gates,
          "matches_serve_streams": (None if serve_streams is None
                                    else serve_streams == ref["streams"]),
          "planted_fault": fault, "tp_shapes": st["tp_shapes"],
          "per_rank": [{k: r[k] for k in ("param_bytes", "kv_heads", "audit", "all_reduce_s",
                                           "run_s", "decode_ms_per_step", "peak_mem_gb",
                                           "first_step_s", "ttft_s", "build_s")}
                       for r in ra],
          "plan_bytes": _tp_plan_bytes(cfg, tp),
          "all_reduce_share_of_run": ra[0]["all_reduce_s"] / ra[0]["run_s"],
          "spec": spec, "row10": row10,
          "wide": {"cfg": {k: w[k] for k in ("tp", "layers", "hidden", "heads", "kv_heads",
                                              "head_dim", "intermediate", "vocab")},
                   **wide_res, "plan_bytes": wplan,
                   "per_rank": [{k: x[k] for k in ("param_bytes", "audit", "all_reduce_s",
                                                    "run_s", "peak_mem_gb")} for x in wr]},
          "launches": launches, "reference_s": ref_s, "spawn_s": spawn_s, "wide_spawn_s": wide_s,
          "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("serve_tp phase failed its checks")


def phase_serve_cp(st):
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.quant.weights import quantize_llama_params
    from quantizedmha_tpu_torch.serving import llama_adapter as la
    from quantizedmha_tpu_torch.serving.engine import EngineConfig
    c = SERVE_CP
    n, page, max_new, dev = c["cp"], c["page"], c["max_new"], st.get("device", "cuda")
    cfg = llama.LlamaConfig.llama3_8b()  # attention_impl "flash": the unsharded side's row 5
    big = max(c["buckets"])
    mpps = -(-(big + max_new + 1) // page)
    ecfg = EngineConfig(num_pages=len(c["prompts"]) * mpps + 2, page_size=page,
                        max_batch=len(c["prompts"]), max_pages_per_seq=mpps,
                        prefill_buckets=c["buckets"], max_new_tokens=max_new)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, m).tolist() for m in c["prompts"]]

    # The unsharded side on the same weights: prefill_at over each padded
    # bucket (its logits, layers 0 and L-1 of its K/V) and the float golden
    # (reference attention), then freed.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(c["seed"])
    params = quantize_llama_params(llama.init_params(cfg, gen, device=dev), bits=8)
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    refs = []
    for p in prompts:
        b = next(x for x in sorted(c["buckets"]) if len(p) <= x)
        toks = torch.zeros((1, b), dtype=torch.int32, device=dev)
        toks[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
        with torch.no_grad():
            logits, k_all, v_all = la.prefill_at(cfg, params, toks, len(p) - 1)
            kv = [x[[0, -1]].cpu() for x in (k_all, v_all)]
            del k_all, v_all
            golden = llama.forward(ref_cfg, params, toks[:, :len(p)])[:, -1].float().cpu()
        refs.append({"logits": logits.float().cpu(), "kv": kv, "golden": golden, "bucket": b})
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    job = dict(name="cp", kind="cp_serve", cfg=cfg, ecfg=ecfg, cp=n, prompts=prompts,
               max_new=max_new, seed=c["seed"], fault_prompt=prompts[1],
               bucket_short=refs[1]["bucket"], device=dev)
    t0 = time.perf_counter()
    ranks = [r["cp"] for r in _spawn_ranks([job], n, c["timeout_s"])]
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    L = cfg.num_layers
    per_prompt = []
    for i, ref in enumerate(refs):
        got = r0["prefill_logits"][i]
        k_cp, v_cp = r0["kv_layers"][i]
        kv_err = {}
        for name, a, b in (("k", k_cp, ref["kv"][0]), ("v", v_cp, ref["kv"][1])):
            a, b = a[:, :, :len(prompts[i])].float(), b[:, :, :len(prompts[i])].float()
            # layer 0: one bf16 rounding of the same projection; layer L-1:
            # the logits' criterion, 0.25 std of the unsharded values.
            kv_err[name] = {"layer0_err_over_ulp": ((a[0] - b[0]).abs()
                                                     / (2.0**-8 * b[0].abs() + 1e-6)).max().item(),
                            "last_rel": _rel(a[1], b[1])}
        per_prompt.append({"len": len(prompts[i]), "bucket": ref["bucket"],
                           "rel_vs_unsharded": _rel(got, ref["logits"][0]),
                           "rel_vs_golden": _rel(got, ref["golden"][0]),
                           "unsharded_rel_vs_golden": _rel(ref["logits"][0], ref["golden"][0]),
                           "kv": kv_err})
    fault_rel = _rel(r0["fault_logits"][0], refs[1]["logits"][0])
    prefills = len(prompts)
    steps = r0["decode_steps"]
    rotations = 2 * (n - 1) * L * prefills
    gates = {
        "logits_vs_unsharded": all(p["rel_vs_unsharded"] <= 0.25 for p in per_prompt),
        "logits_vs_golden": all(p["rel_vs_golden"] <= 0.25 for p in per_prompt),
        "kv_layers": all(e["layer0_err_over_ulp"] <= 1 and e["last_rel"] <= 0.25
                         for p in per_prompt for e in p["kv"].values()),
        "ranks_bit_equal": all(r["streams"] == r0["streams"] for r in ranks),
        "tokens": all(len(t) == max_new for t in r0["streams"]),
        "launches": all(r["launches"] == {"flash_fwd[bf16]": n * L * prefills,
                                          "paged_decode": L * r["decode_steps"]}
                        for r in ranks),
        "audit": all(r["audit"]["counts"] == {"collective-permute": rotations,
                                              "all-gather": prefills} for r in ranks),
        "row5": all(r["row5"]["err_over_tol"] <= 1 for r in ranks),
        "drained": all(r["drained"] for r in ranks),
    }
    fault = {"planted": "rank-local positions in RoPE", "rel_vs_unsharded": fault_rel,
             "caught": fault_rel > 0.25}
    for name, k in (("flash_fwd[bf16]", "flash_fwd[bf16]"), ("paged_decode", "paged_decode")):
        st["launches"][name] = st["launches"].get(name, 0) + r0["launches"][k]
    st["cp_shapes"] = {"flash_fwd[bf16]": r0["row5"]}
    ok = all(gates.values()) and fault["caught"]
    print(f"chip_smoke serve_cp: planted fault ({fault['planted']}) "
          f"{'caught' if fault['caught'] else 'NOT caught'}: {fault_rel:.3g} std", flush=True)
    emit({"phase": "serve_cp", "ok": ok, "model": "llama3_8b", "layers": L, "cp": n,
          "transport": f"{n} processes time-sharing one card, gloo through the host",
          "gates": gates, "prompts": per_prompt, "planted_fault": fault,
          "per_rank": [{k: r[k] for k in ("ttft_s", "decode_ms_per_step", "peak_mem_gb",
                                           "audit", "row5", "build_s", "launches")}
                       for r in ranks],
          "decode_steps": steps, "reference_s": ref_s, "spawn_s": spawn_s, "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("serve_cp phase failed its checks")


TRAIN = dict(tokens=2048, steps=4, lr=0.5, check_layers=2, grad_rel_tol=2.0**-4)


def _leaf_grads(cfg, params, tokens):
    """Every float leaf's gradient of loss_fn through sgd_train_step's
    leaves (one a layer): {name: tensor}, layers stacked."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    leaves = llama.float_leaves(params)
    llama.loss_fn(cfg, leaves, tokens).backward()
    grads = {k: v.grad for k, v in leaves.items() if k != "layers"}
    grads.update({f"layers.{k}": torch.stack([r.grad for r in rows])
                  for k, rows in leaves["layers"].items()})
    return grads


def phase_train(st):
    """sgd_train_step of LlamaConfig.llama3_8b() as configured (bf16,
    attention_impl="flash", 32 layers, random weights from seed 0) on one
    batch of 2048 random tokens, TRAIN["steps"] steps (the first pays the
    one-time costs: tokens/s is over the others): every forward through
    row 5, every backward through rows 6 and 7. Then the same width cut to
    2 layers: one step's gradients through the kernels against autograd
    through the float golden (attention_impl="reference")."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = TRAIN
    cfg = llama.LlamaConfig.llama3_8b()
    L, steps = cfg.num_layers, tr["steps"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, tr["tokens"]), generator=g, device="cuda",
                           dtype=torch.int32)
    with torch.no_grad():
        loss_direct = float(llama.loss_fn(cfg, params, tokens))

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "flash_bwd_dkv": fa.FLASH_BWD_DKV, "flash_bwd_dq": fa.FLASH_BWD_DQ,
               "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P}
    for kern in kernels.values():
        kern.reset()
    losses, step_ms = [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        params, loss = llama.sgd_train_step(cfg, params, tokens, lr=tr["lr"])
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_fwd[bf16]": L * steps, "flash_fwd[f32]": 0, "flash_bwd_dkv": L * steps,
            "flash_bwd_dq": L * steps, "flash_int8_fwd[int8_p]": 0, "flash_int8_fwd[bf16_p]": 0}
    for name in ("flash_fwd[bf16]", "flash_bwd_dkv", "flash_bwd_dq"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]

    # Finite weights after the steps (a NaN or inf gradient would reach
    # them) and the share of weights the steps changed, against a fresh
    # draw of the same init.
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [params[k] for k in params if k != "layers"] + list(params["layers"].values()))
    init = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    changed = n_all = 0
    for a, b in zip([params[k] for k in params if k != "layers"] + list(params["layers"].values()),
                    [init[k] for k in init if k != "layers"] + list(init["layers"].values())):
        changed += int((a != b).sum())
        n_all += a.numel()
    del init
    if st.get("profile"):
        emit({"phase": "train_profile", "step": _profile_prefill(
            lambda: llama.sgd_train_step(cfg, params, tokens, lr=tr["lr"]))})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # The wiring of the autograd Function on the card: at the same width cut
    # to 2 layers, one step's gradient of every leaf through the kernels
    # against autograd through mha_masked_reference (its S x S tensors do
    # not fit at 32 layers). Both compute attention in f32 from bf16 inputs
    # but round its bf16 output at other places (the kernel's P in bf16 for
    # P·V), which moves a bf16 gradient by a few per cent of its leaf's
    # largest entry; a lost GQA head or a swapped dK/dV moves it by 25-100%.
    cut = dataclasses.replace(cfg, num_layers=tr["check_layers"])
    grads = {}
    for impl in ("flash", "reference"):
        p2 = llama.init_params(cut, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        grads[impl] = _leaf_grads(dataclasses.replace(cut, attention_impl=impl), p2, tokens)
        del p2
    grad_rel = {k: ((grads["flash"][k].float() - grads["reference"][k].float()).abs().max()
                    / grads["reference"][k].float().abs().max()).item() for k in grads["flash"]}
    grads_finite = all(bool(torch.isfinite(x).all()) for x in grads["flash"].values())
    del grads
    torch.cuda.empty_cache()

    ok = (launches == want and finite and grads_finite
          and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - loss_direct) <= 1e-5 * abs(loss_direct)
          and all(b < a for a, b in zip(losses, losses[1:]))
          and max(grad_rel.values()) <= tr["grad_rel_tol"])
    step_s = sum(step_ms[1:]) / len(step_ms[1:]) / 1e3
    emit({"phase": "train", "ok": ok, "model": "llama3_8b", "attention_impl": "flash",
          "layers": L, "weights": "bf16", "init_s": init_s, "batch": 1, "tokens": tr["tokens"],
          "lr": tr["lr"], "steps": steps, "losses": losses, "loss_no_grad": loss_direct,
          "step_ms": step_ms, "tokens_per_s_after_first": tr["tokens"] / step_s,
          "share_of_weights_changed": changed / n_all, "weights_finite": finite,
          "launches": launches, "launches_expected": want, "peak_mem_gb": peak_gb,
          "grad_check_layers": tr["check_layers"], "grad_rel_err_vs_reference": grad_rel,
          "grad_rel_tol": tr["grad_rel_tol"], "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("train phase failed its checks")


# Gemma-2-9B training (phase_train_gemma2): LlamaConfig.gemma2_9b() at full
# width (hidden 3584, 16 q / 8 kv heads of 256, MLP 14336, vocabulary
# 256000) on one batch of Gemma-2's 8192-token context, where the even
# layers' 4096 window masks half of the last rows' keys. Depth cut from 42
# to 8 layers (4 sliding, 4 full): at 8192 tokens the 42 layers' weights
# and gradients (~40 GB in bf16), their activations and the f32 logits
# tensors of the loss (8192 x 256000 x 4 B = 8.4 GB each, several alive in
# its backward) do not fit in 80 GB; at 8 layers weights and gradients take
# 6.9 GB each, the logits 30-40 GB, the activations ~8-28 GB. The gradient
# check: the same width at 2 layers (one sliding, one full) on 5120 tokens
# (the window still bites; the reference's S x S tensors are 1.7 GB each).
TRAIN_GEMMA2 = dict(tokens=8192, layers=8, steps=4, check_layers=2, check_tokens=5120,
                    dtype="bfloat16", grad_rel_tol=TRAIN["grad_rel_tol"], loss_rel_tol=1e-5)
# The same in f32 (phase_train_gemma2_f32), depth cut to 4 layers (2
# sliding, 2 full): weights and gradients take 10.5 GB each ((4 x 198.2M +
# 2 x 917.5M) params x 4 B); the 4 f32 layers' activations equal 8 bf16
# layers', whose phase peaked at 60.9 GB with 13.8 GB of weights and
# gradients, so ~21 + 47 = 68 GB. At 8 f32 layers it passes 80 GB; above 76
# GB measured, cut to 2 layers (never fewer tokens: they keep the window
# biting). Gradient tolerance: f32 on both sides, which differ only in the
# attention's summation order (the kernels' against mha_masked_reference's
# materialized softmax): the linear bound of two orders over the longest
# sum, 2 (5120 + 256) 2^-24 = 6.4e-4 of the sums' magnitudes, rounded up to
# 2^-10 of each leaf's largest entry (bf16's gate is 2^-4). The first
# step's loss: the same kernels on the same weights as loss_fn without
# grad, within 1e-6.
TRAIN_GEMMA2_F32 = dict(TRAIN_GEMMA2, layers=4, dtype="float32", grad_rel_tol=2.0**-10,
                        loss_rel_tol=1e-6)


def _train_gemma2_run(st, phase, tg):
    """sgd_train_step of LlamaConfig.gemma2_9b() in tg["dtype"] at full
    width, depth cut to tg["layers"] (attention_impl="flash", random weights
    from seed 0), on one batch of 8192 random tokens, tg["steps"] steps at
    TRAIN's lr (tokens/s over the steps after the first): every forward
    through row 5 and every backward through rows 6 and 7 at head_dim 256
    (softcap 50, the window on the even layers), the route of each backward
    launch recorded (head_dim and bf16 flag). Then the same width cut to 2
    layers on 5120 tokens: one step's gradient of every leaf through the
    kernels against autograd through the float golden (attention_impl=
    "reference"), each within tg["grad_rel_tol"] of the leaf's largest
    entry."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dtype = getattr(torch, tg["dtype"])
    bf16 = dtype == torch.bfloat16
    full = dataclasses.replace(llama.LlamaConfig.gemma2_9b(), dtype=dtype)

    def cut(layers):
        return dataclasses.replace(full, num_layers=layers,
                                   window_pattern=full.window_pattern[:layers])
    cfg = cut(tg["layers"])
    L, steps, lr = cfg.num_layers, tg["steps"], TRAIN["lr"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [x for x in _flat_tree(params).values() if isinstance(x, torch.Tensor)]
    weights_gb = sum(x.numel() * x.element_size() for x in leaves) / 1e9
    del leaves
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, tg["tokens"]), generator=g, device="cuda",
                           dtype=torch.int32)
    with torch.no_grad():
        loss_direct = float(llama.loss_fn(cfg, params, tokens))

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "flash_bwd_dkv": fa.FLASH_BWD_DKV, "flash_bwd_dq": fa.FLASH_BWD_DQ,
               "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P}
    routes = []  # (head_dim, bf16 flag) of each backward launch built
    bwd_launch = fa._flash_bwd_launch

    def recorded(*a, **kw):
        out = bwd_launch(*a, **kw)
        routes.extend((args[-9], args[-2]) for _, args in out[0])
        return out
    for kern in kernels.values():
        kern.reset()
    losses, step_ms = [], []
    with _Patched((fa, "_flash_bwd_launch", recorded)):
        for _ in range(steps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            params, loss = llama.sgd_train_step(cfg, params, tokens, lr=lr)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd = "flash_fwd[bf16]" if bf16 else "flash_fwd[f32]"
    want = {name: 0 for name in kernels}
    want.update({fwd: L * steps, "flash_bwd_dkv": L * steps, "flash_bwd_dq": L * steps})
    routes_ok = routes == [(cfg.hd, int(bf16))] * (2 * L * steps)
    key = "launches_d256" if bf16 else "launches_d256_f32"
    for name in (fwd, "flash_bwd_dkv", "flash_bwd_dq"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
        st[key][name] = st[key].get(name, 0) + launches[name]
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [params[k] for k in params if k != "layers"] + list(params["layers"].values()))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # Every leaf's gradient through the kernels against autograd through
    # mha_masked_reference, at 2 layers on the first check_tokens tokens.
    small = cut(tg["check_layers"])
    toks = tokens[:, :tg["check_tokens"]]
    grads = {}
    for impl in ("flash", "reference"):
        p2 = llama.init_params(small, torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
        grads[impl] = _leaf_grads(dataclasses.replace(small, attention_impl=impl), p2, toks)
        del p2
        gc.collect()
        torch.cuda.empty_cache()
    grad_rel = {k: ((grads["flash"][k].float() - grads["reference"][k].float()).abs().max()
                    / grads["reference"][k].float().abs().max()).item() for k in grads["flash"]}
    grads_finite = all(bool(torch.isfinite(x).all()) for x in grads["flash"].values())
    del grads
    torch.cuda.empty_cache()

    ok = (launches == want and routes_ok and finite and grads_finite
          and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - loss_direct) <= tg["loss_rel_tol"] * abs(loss_direct)
          and all(b < a for a, b in zip(losses, losses[1:]))
          and max(grad_rel.values()) <= tg["grad_rel_tol"])
    step_s = sum(step_ms[1:]) / len(step_ms[1:]) / 1e3
    emit({"phase": phase, "ok": ok, "model": "gemma2_9b", "attention_impl": "flash",
          "layers": L, "layers_published": full.num_layers, "windows": list(cfg.layer_windows),
          "weights": tg["dtype"], "weights_gb": weights_gb, "init_s": init_s, "batch": 1,
          "tokens": tg["tokens"], "lr": lr, "steps": steps, "losses": losses,
          "loss_no_grad": loss_direct, "loss_rel_tol": tg["loss_rel_tol"], "step_ms": step_ms,
          "tokens_per_s_after_first": tg["tokens"] / step_s, "weights_finite": finite,
          "launches": launches, "launches_expected": want,
          "bwd_routes_ok": routes_ok, "bwd_routes": sorted(set(routes)),
          "peak_mem_gb": peak_gb,
          "grad_check_layers": tg["check_layers"], "grad_check_tokens": tg["check_tokens"],
          "grad_rel_err_vs_reference": grad_rel, "grad_rel_tol": tg["grad_rel_tol"],
          "gpu": st["gpu"]})
    if not ok:
        raise AssertionError(f"{phase} phase failed its checks")


def phase_train_gemma2(st):
    """Gemma-2-9B trained in bf16 at full width, 8 layers (TRAIN_GEMMA2,
    _train_gemma2_run), within TRAIN["grad_rel_tol"] of the float golden."""
    _train_gemma2_run(st, "train_gemma2", TRAIN_GEMMA2)


def phase_train_gemma2_f32(st):
    """Gemma-2-9B trained in f32 at full width, 4 layers (TRAIN_GEMMA2_F32,
    _train_gemma2_run): rows 5, 6 and 7 on their f32 routes at head_dim 256,
    the gradients within 2^-10 of the float golden's."""
    _train_gemma2_run(st, "train_gemma2_f32", TRAIN_GEMMA2_F32)


# Training across ranks (phase_train_parallel): 4 processes on GPU 0 joined
# by gloo, one spawn running three jobs. (a) DP x TP: dp 2 x tp 2 at
# Llama-3-8B's width, depth cut to 4 layers, 2048 tokens a dp rank, 3 steps;
# each rank holds ~2.4 GB of parameter shards (embed replicated 1.05 GB,
# lm_head half 0.53 GB, 4 layers' halves 0.87 GB) and as much of
# gradients, with its clone for the planted faults and the flattened dp
# buffer: ~12 GB a rank at peak with the activations. (b) PP: pp 4 at the
# same width, 8 layers (2 a stage), a batch of 4 x 512 tokens in 4
# microbatches. (c) CP: cp 4 at Llama-3-8B's attention width, 32768 tokens,
# 8192 a rank. lr: train's.
TRAIN_PARALLEL = dict(world=4, timeout_s=600, seed=0, lr=0.5, grad_rel_tol=2.0**-4,
                      loss_rel_tol=2e-3, granule=2, model={},
                      dp_tp=dict(dp=2, tp=2, layers=4, tokens=2048, steps=3),
                      pp=dict(pp=4, layers=8, batch=4, seq=512, n_micro=4),
                      cp=dict(cp=4, seq=32768, Hq=32, Hkv=8, D=128, block_kv=512, suffix=2048,
                              rows=4096))


def _ref_step(cfg, params, tokens, lr):
    """sgd_train_step(mesh=None)'s arithmetic, also returning the gradients
    as a tree shaped like params (layers stacked): (loss, grads)."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    leaves = llama.float_leaves(params)
    loss = llama.loss_fn(cfg, leaves, tokens)
    loss.backward()
    grads = {k: v.grad for k, v in leaves.items() if k != "layers"}
    grads["layers"] = {k: torch.stack([r.grad for r in rows])
                       for k, rows in leaves["layers"].items()}
    with torch.no_grad():
        for p in llama._leaf_list(leaves):
            p.sub_(torch.tensor(lr, dtype=p.dtype, device=p.device) * p.grad.to(p.dtype))
    return loss.item(), grads


def _named_grads(params, grads_list):
    """{name: gradient} from _dp_average's leaves (in _leaf_list's order:
    the top-level leaves, then each layer key's layers), layers stacked."""
    import torch
    names = [k for k in params if k != "layers"]
    out = dict(zip(names, grads_list[:len(names)]))
    rest = grads_list[len(names):]
    L = len(next(iter(params["layers"].values())))
    for j, k in enumerate(params["layers"]):
        out[f"layers.{k}"] = torch.stack(rest[j * L:(j + 1) * L])
    return out


def _flat_tree(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    return out


def _grad_rel(got, ref, dev="cuda"):
    """Each leaf's max |got - ref| / max |ref| (on the card, a leaf at a
    time)."""
    out = {}
    for k in ref:
        g, r = got[k].to(dev).float(), ref[k].to(dev).float()
        out[k] = ((g - r).abs().max() / r.abs().max()).item()
    return out


class _Patched:
    """Module attributes swapped for the length of a block (a planted
    fault), restored after."""

    def __init__(self, *patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name)) for obj, name, _ in self.patches]
        for obj, name, value in self.patches:
            setattr(obj, name, value)

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def _train_kernels():
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    return {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
            "flash_bwd_dq": fa.FLASH_BWD_DQ, "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P}


def _empty_cache(dev) -> None:
    import torch
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()


def _sync(dev) -> None:
    import torch
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def _peak_gb(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 1e9 if str(dev).startswith("cuda") else 0.0


def _counted(fn, dev="cuda"):
    """fn() with the train kernels' launch counts zeroed before and read
    after: (result, launches)."""
    kernels = _train_kernels()
    for k in kernels.values():
        k.reset()
    out = fn()
    _sync(dev)
    return out, {n: k.launches for n, k in kernels.items()}


def _rank_dp_tp(rank, job):
    """(a): this rank's shard restored from the parent's checkpoint, three
    DP x TP steps (launches counted, collectives recorded, the first step's
    averaged gradients kept), then each planted fault for one step from the
    same shards."""
    import torch
    import torch.distributed as dist
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.parallel import combine, hybrid_mesh, record_collectives
    from quantizedmha_tpu_torch.parallel.distributed import classify_collectives, collective_bytes
    from quantizedmha_tpu_torch.parallel.distributed import train_step_collectives
    from quantizedmha_tpu_torch.utils.checkpoint import CheckpointManager
    cfg, c, lr, dev = job["cfg"], job["c"], job["lr"], job["device"]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh = hybrid_mesh((c["dp"],), (c["tp"],), ("dp",), ("tp",), device_type="cpu")
    specs = llama.param_shardings(cfg)
    like = llama.init_params(cfg, device="meta")
    t0 = time.perf_counter()
    params = CheckpointManager(job["weights"]).restore_sharded(like, specs, mesh, device=dev)
    ref = _flat_tree(CheckpointManager(job["grads"]).restore_sharded(like, specs, mesh,
                                                                      device="cpu"))
    restore_s = time.perf_counter() - t0
    init = {k: v.cpu() for k, v in _flat_tree(params).items()}
    tokens = job["tokens"][mesh.get_local_rank("dp")][None].to(dev)
    captured = []
    orig = llama._dp_average

    def spy_on(average):
        """`average` keeping the first step's averaged gradients (on the
        host)."""
        def spy(leaves, loss, group):
            out = average(leaves, loss, group)
            if not captured:
                captured.append([p.grad.cpu() for p in leaves])
            return out
        return spy

    def steps(n):
        losses, step_s, records = [], [], []
        for _ in range(n):
            _sync(dev)
            t = time.perf_counter()
            with record_collectives() as rec:
                _, loss = llama.sgd_train_step(cfg, params, tokens, lr, mesh=mesh)
            _sync(dev)
            step_s.append(time.perf_counter() - t)
            losses.append(float(loss))
            records.append(rec)
        return losses, step_s, records

    with _Patched((llama, "_dp_average", spy_on(orig))):
        (losses, step_s, records), launches = _counted(lambda: steps(c["steps"]), dev)
    grad_rel = _grad_rel(_named_grads(params, captured[0]), ref, dev)
    finite = all(bool(torch.isfinite(v).all()) for v in _flat_tree(params).values())
    want = train_step_collectives(cfg, params, tuple(tokens.shape))
    groups = {a: tuple(dist.get_process_group_ranks(mesh.get_group(a))) for a in ("dp", "tp")}
    got = [(r.kind, r.dtype, r.nbytes, r.ranks) for r in records[0]]
    audit = {"exact": got == [(w["kind"], w["dtype"], w["nbytes"], groups[w["axis"]])
                              for w in want],
             "every_step": all([(r.kind, r.dtype, r.nbytes, r.ranks) for r in rec] == got
                               for rec in records),
             "by_axis": classify_collectives(records[0], job["granule"]),
             "bytes_by_axis": collective_bytes(records[0], job["granule"]),
             "want_by_axis": {"ici": {"all-reduce": sum(w["axis"] == "tp" for w in want)},
                              "dcn": {"all-reduce": sum(w["axis"] == "dp" for w in want)}},
             "want_bytes_by_axis": {
                 "ici": sum(w["nbytes"] for w in want if w["axis"] == "tp"),
                 "dcn": sum(w["nbytes"] for w in want if w["axis"] == "dp")},
             "collective_host_s": [sum(r.seconds for r in rec) for rec in records]}
    peak = _peak_gb(dev)

    def summed_avg(leaves, loss, group):  # the dp gradient summed, not averaged
        out = orig(leaves, loss, group)
        for p in leaves:
            p.grad.mul_(dist.get_world_size(group))
        return out

    def no_reduce(ctx, g):  # copy_to_group without its backward all-reduce
        return g, None
    faults = {}
    for name, patches in (("dp gradient summed, not averaged",
                           ((llama, "_dp_average", spy_on(summed_avg)),)),
                          ("copy_to_group without its backward all-reduce",
                           ((combine._CopyToGroup, "backward", staticmethod(no_reduce)),
                            (llama, "_dp_average", spy_on(orig))))):
        params = {k: init[k].to(dev) for k in ("embed", "final_norm", "lm_head")}
        params["layers"] = {k[7:]: v.to(dev) for k, v in init.items() if k.startswith("layers.")}
        captured.clear()
        with _Patched(*patches):
            _, floss = llama.sgd_train_step(cfg, params, tokens, lr, mesh=mesh)
        frel = _grad_rel(_named_grads(params, captured[0]), ref, dev)
        faults[name] = {"max_grad_rel": max(frel.values()), "loss": float(floss)}
    del params, init, ref
    return {"losses": losses, "step_s": step_s, "launches": launches, "grad_rel": grad_rel,
            "weights_finite": finite, "audit": audit, "peak_mem_gb": peak,
            "restore_s": restore_s, "faults": faults,
            "coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("tp"))}


def _pp_loss(logits, tokens):
    """loss_fn's shifted cross-entropy from the logits."""
    import torch
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long())[..., 0].mean()


def _rank_pp(rank, job):
    """(b): the parent's weights made again from the seed, this stage's two
    layers kept as leaves; the pipeline's logits and its loss's gradients,
    then once more with a planted fault (each stage's sends drop
    microbatch 0's gradient)."""
    import hashlib
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.parallel import make_mesh, pipeline_llama_forward
    from quantizedmha_tpu_torch.parallel import pipeline as pl
    cfg, c, dev = job["cfg"], job["c"], job["device"]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((c["pp"],), ("pp",), device_type="cpu")
    stage = mesh.get_local_rank("pp")
    per = cfg.num_layers // c["pp"]
    full = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(job["seed"]),
                             device=dev)
    params = {k: v for k, v in full.items() if k != "layers"}
    params["layers"] = {k: v[stage * per:(stage + 1) * per].clone()
                        for k, v in full["layers"].items()}
    del full
    tokens = job["tokens"].to(dev)
    ref = torch.load(job["ref"], weights_only=False)
    ref_grads = ref["stages"][stage]

    def run():
        leaves = llama.float_leaves(params)
        _sync(dev)
        t = time.perf_counter()
        logits = pipeline_llama_forward(cfg, leaves, tokens, mesh, n_microbatches=c["n_micro"])
        loss = _pp_loss(logits, tokens)
        loss.backward()
        _sync(dev)
        grads = {k: torch.stack([r.grad for r in rows]).cpu()
                 for k, rows in leaves["layers"].items()}
        return logits.detach(), loss.item(), grads, time.perf_counter() - t
    (logits, loss, grads, run_s), launches = _counted(run, dev)
    logits_ref = ref["logits"].to(dev)
    out = {"stage": stage, "launches": launches, "loss": loss, "run_s": run_s,
           "rel_vs_unsharded": _rel(logits, logits_ref),
           "logits_sha1": hashlib.sha1(logits.cpu().numpy().tobytes()).hexdigest(),
           "grad_rel": _grad_rel(grads, ref_grads, dev),
           "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
           "peak_mem_gb": _peak_gb(dev)}
    del logits, grads
    orig = pl._SendOn.backward

    def drop_first(ctx, token):  # a stage that drops microbatch 0's gradient
        _, _, g = orig(ctx, token)
        return None, None, torch.zeros_like(g) if ctx.comm[2] == 0 else g
    with _Patched((pl._SendOn, "backward", staticmethod(drop_first))):
        _, _, fgrads, _ = run()
    out["fault_max_grad_rel"] = max(_grad_rel(fgrads, ref_grads, dev).values())
    del fgrads, params, ref_grads, logits_ref
    return out


def _cp_inputs(c, seed, device="cuda"):
    """q, k, v [1, H, S, D] bf16 and the output cotangent, from the seed."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    S, D = c["seq"], c["D"]

    def draw(h):
        return (torch.randn((1, h, S, D), generator=g, device=device) * 0.5).to(torch.bfloat16)
    return draw(c["Hq"]), draw(c["Hkv"]), draw(c["Hkv"]), draw(c["Hq"])


def _rank_cp(rank, job):
    """(c): ring_attention, ring_attention_int8, ring_attention at the
    shards' dequantized K/V (the INT8 ring's backward must equal it bit for
    bit) and context_parallel_attention with a suffix q, each forward and
    backward of sum(out * cotangent); then the planted faults (the ring's
    gradient rotation sent right; the INT8 ring's straight-through backward
    at the raw K/V)."""
    import torch
    from quantizedmha_tpu_torch.parallel import (context_parallel_attention, make_mesh,
                                                 ring_attention, ring_attention_int8)
    from quantizedmha_tpu_torch.parallel import ring
    c, dev = job["c"], job["device"]
    mesh = make_mesh((c["cp"],), ("cp",), device_type="cpu")
    group, idx = mesh.get_group("cp"), mesh.get_local_rank("cp")
    full = _cp_inputs(c, job["seed"], dev)
    q, k, v, do = (x.chunk(c["cp"], dim=2)[idx].contiguous() for x in full)
    q_suffix, do_suffix = (x[:, :, -c["suffix"]:].contiguous() for x in (full[0], full[3]))
    del full
    k_deq, v_deq = ring._ste_residuals(k, v, c["block_kv"])

    def grads(fn, q_, k_, v_, ct, **kw):
        def run():
            qq, kk, vv = (x.detach().requires_grad_() for x in (q_, k_, v_))
            out = fn(qq, kk, vv, group=group, causal=True, **kw)
            (out.float() * ct.float()).sum().backward()
            return [x.grad.cpu() for x in (qq, kk, vv)]
        return _counted(run, dev)
    res = {}
    for name, fn, args, kw in (
            ("ring", ring_attention, (q, k, v, do), {}),
            ("ring_int8", ring_attention_int8, (q, k, v, do), dict(block_kv=c["block_kv"])),
            ("ring_at_dequantized", ring_attention, (q, k_deq, v_deq, do), {}),
            ("context_parallel", context_parallel_attention, (q_suffix, k, v, do_suffix), {})):
        _sync(dev)
        t = time.perf_counter()
        (g, launches) = grads(fn, *args, **kw)
        res[name] = {"grads": g, "launches": launches, "wall_s": time.perf_counter() - t}
    with _Patched((ring, "_BACKWARD_SHIFT", 1)):
        res["fault_rotation_right"] = grads(ring_attention, q, k, v, do)[0]
    with _Patched((ring, "_ste_residuals", lambda k_, v_, b: (k_, v_))):
        res["fault_ste_raw"] = grads(ring_attention_int8, q, k, v, do,
                                     block_kv=c["block_kv"])[0]
    return res


def _rank_train_parallel(rank, job):
    """The three jobs of phase_train_parallel in one spawn, each with the
    card's memory released after it."""
    import torch
    out = {}
    for name, fn in (("dp_tp", _rank_dp_tp), ("pp", _rank_pp), ("cp", _rank_cp)):
        out[name] = fn(rank, dict(job[name], device=job["device"]))
        gc.collect()
        if job["device"] == "cuda":
            torch.cuda.empty_cache()
    return out


def ring_grad_tolerances(q, k, v, o, lse, do, grads, q_offset, n, *, rows):
    """Per-element tolerances (dq, dk, dv) of a sequence-parallel backward
    over n ranks (ring_attention, the INT8 ring's straight-through backward,
    context_parallel_attention; bf16, causal, no window) against the flash
    kernel's backward over the unsharded sequence, whose forward gave o and
    lse and whose gradients are `grads`: 2 T + R.

    T is flash_bwd_tolerances's bound of the backward kernels against their
    plain version, evaluated over the unsharded sequence in blocks of
    `rows` q rows (keys past a causal block's last row are masked and add
    nothing), with the whole sequence's summation lengths. Each side's
    kernels are within T of the plain arithmetic: the sequence-parallel
    side sums, over its steps, the same terms over disjoint key (dq) or row
    (dk, dv) ranges at each step's lse and merge-weighted dO (p_s w_s = p,
    dP_s = w_s dP, di_s = w_s di: the step's dS is the global one), so its
    kernels' errors are bounded by the same sums; hence the 2.

    R bounds what only the sequence-parallel side rounds (u8 = 2^-8, a
    bf16 half ulp): each step's dO (w_s dO, rounded to bf16 by the merge's
    backward) moves dV by u8 pᵀ|dO| and dS by u8 p |dO|·|V|ᵀ scale; each
    step's gradients are written in bf16 and summed in bf16 across the n
    steps (the ring's rotations, context parallelism's all-reduce of dQ):
    2n + 2 roundings of at most u8 of the magnitude sums M_dq = |dS|·|K|,
    M_dk = |dS|ᵀ|Q|, M_dv = Pᵀ|dO|; and di: the sequence-parallel side
    takes it of the merged f32 output, the reference of its own bf16 o;
    both outputs are within 2^-7 (|o| + max|v|) of the exact one
    (flash_fwd_tolerances's bf16 terms, ds negligible at this width), so
    di moves by at most delta = |dO|·2^-6 (|o| + max|v|), and dS by
    p delta scale."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    u, u8 = 2.0**-24, 2.0**-8
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    sm = D ** -0.5
    offsets = fa._offsets(q_offset, 0, B, q.device)
    di_all = fa._bwd_di(o, do, None)
    tols = [torch.zeros(x.shape, dtype=torch.float64, device=x.device) for x in grads]
    extra = [torch.zeros(x.shape, dtype=torch.float64, device=x.device) for x in grads]
    g_kv, g_q = 2 * (Skv + 1) * u, 2 * (G * Sq + 1) * u
    for h in range(Hkv):
        grp = slice(h * G, (h + 1) * G)
        kh, vh = k[:, h].float(), v[:, h].float()
        kn = kh.norm(dim=-1).amax(dim=-1)[:, None, None]
        vn = vh.norm(dim=-1).amax(dim=-1)[:, None, None]
        vmax = vh.abs().amax()
        for r0 in range(0, Sq, rows):
            r1 = min(Sq, r0 + rows)
            kend = min(Skv, q_offset + r1)  # causal: later keys are masked
            qh = q[:, grp, r0:r1].float()
            doh = do[:, grp, r0:r1].float()
            oh = o[:, grp, r0:r1].float()
            di = di_all[:, grp, r0:r1]
            lse_h = lse[:, grp, r0:r1].float()
            kc, vc = kh[:, :kend], vh[:, :kend]
            q_pos, k_pos = fa._bwd_positions(offsets, Sq, kend)
            p, dp, ds = fa._bwd_pairs(qh, kc, vc, doh, lse_h, di, q_pos[:, r0:r1], k_pos,
                                      sm_scale=sm, causal=True, window=None, softcap=None,
                                      sinks=0)
            e_s = (2 * D + 33) * u * qh.norm(dim=-1) * kn * sm
            lse_a = torch.nan_to_num(lse_h.abs(), posinf=0.0)
            delta = 1.01 * e_s + 2.0**-22 * (1.0 + lse_a) + 2.0**-21
            e_dp = 2 * (D + 16) * u * doh.norm(dim=-1) * vn
            A = p * (sm * (delta + 4 * u)[..., None] * (dp - di[..., None]).abs()
                     + sm * e_dp[..., None]) + 2.0**-7 * ds.abs()
            e_p = p * delta[..., None] + 2.0**-7 * p
            d_di = (doh.abs() * 2.0**-6 * (oh.abs() + vmax)).sum(dim=-1)
            E = p * sm * (u8 * (doh.abs() @ vc.abs()[:, None].transpose(-1, -2))
                         + d_di[..., None])
            ka, qa, da = kc.abs()[:, None], qh.abs(), doh.abs()
            dsa = ds.abs()
            tols[0][:, grp, r0:r1] += (A @ ka + g_kv * (dsa @ ka)).double()
            tols[1][:, h, :kend] += (torch.einsum("bgqk,bgqd->bkd", A, qa)
                                     + g_q * torch.einsum("bgqk,bgqd->bkd", dsa, qa)).double()
            tols[2][:, h, :kend] += (torch.einsum("bgqk,bgqd->bkd", e_p, da)
                                     + g_q * torch.einsum("bgqk,bgqd->bkd", p, da)).double()
            m = (2 * n + 2) * u8
            extra[0][:, grp, r0:r1] += (m * (dsa @ ka) + E @ ka).double()
            extra[1][:, h, :kend] += (m * torch.einsum("bgqk,bgqd->bkd", dsa, qa)
                                      + torch.einsum("bgqk,bgqd->bkd", E, qa)).double()
            extra[2][:, h, :kend] += ((m + u8) * torch.einsum("bgqk,bgqd->bkd", p, da)).double()
            del p, dp, ds, A, e_p, E, dsa
    tols = [t + 2.0**-7 * (g.double().abs() + t) for t, g in zip(tols, grads)]
    return [2.0 * t + x for t, x in zip(tols, extra)]


def _train_parallel_kernels(c):
    """Rows 5, 6 and 7 at a tp rank's attention shape (16 q / 4 kv heads,
    2048 tokens, causal) and at a ring step (8192 q rows against an 8192-key
    block on the diagonal, global offsets 8192, a seeded lse cotangent),
    and row 1 at an INT8 ring step (block_kv 512), each against its plain
    version: {kernel: {shape name: {err_over_tol, shape}}}."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.parallel import ring
    g = torch.Generator(device="cuda").manual_seed(7)

    def draw(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    out = {"flash_fwd[bf16]": {}, "flash_bwd_dkv": {}, "flash_bwd_dq": {},
           "flash_int8_fwd[int8_p]": {}}
    shard, D = c["seq"] // c["cp"], c["D"]
    for name, (H, Hkv, S, off, dlse) in (("tp", (16, 4, 2048, 0, False)),
                                         ("ring_step", (c["Hq"], c["Hkv"], shard, shard, True))):
        q, k, v, do = draw(1, H, S, D), draw(1, Hkv, S, D), draw(1, Hkv, S, D), draw(1, H, S, D)
        offsets = fa._offsets(off, off, 1, q.device)
        _, _, ratios, _, _, _ = _flash_fwd_check(q, k, v, offsets, causal=True)
        shape = {"B": 1, "Hq": H, "Hkv": Hkv, "Sq": S, "Skv": S, "q_offset": off,
                 "kv_offset": off}
        out["flash_fwd[bf16]"][name] = {"err_over_tol": max(ratios), **shape}
        dl = (torch.randn((1, H, S), generator=g, device="cuda") if dlse else None)
        _, _, bwd_ratios, _, _, _, same, _ = _flash_bwd_check(q, k, v, offsets, do, dl,
                                                              causal=True)
        for kern, ratio in (("flash_bwd_dkv", max(bwd_ratios[1:])),
                            ("flash_bwd_dq", bwd_ratios[0])):
            out[kern][name] = {"err_over_tol": ratio if same else float("inf"),
                               "dlse": dlse, **shape}
        del q, k, v, do
    q, k, v = draw(1, c["Hq"], shard, D), draw(1, c["Hkv"], shard, D), draw(1, c["Hkv"], shard, D)
    k_i8, ks, v_i8, vs = ring.quantize_shard(k, v, c["block_kv"])
    kw = dict(block_kv=c["block_kv"], causal=True, q_offset=shard, kv_offset=shard,
              save_residuals=True)
    o, lse = fa8.flash_attention_int8_prequant(q, k_i8, ks, v_i8, vs, **kw)
    o_p, lse_p, _, tol_o, tol_lse = _int8_plain(q, k_i8, ks, v_i8, vs, shard, shard,
                                                causal=True, mode=0)
    out["flash_int8_fwd[int8_p]"]["ring_step"] = {
        "err_over_tol": max(err_over_tol(o, o_p, tol_o), err_over_tol(lse, lse_p, tol_lse)),
        "B": 1, "Hq": c["Hq"], "Hkv": c["Hkv"], "Sq": shard, "Skv": shard,
        "q_offset": shard, "kv_offset": shard, "block_kv": c["block_kv"]}
    return out


def _cp_reference(c, seed, dev="cuda"):
    """The flash kernel's forward and backward over the unsharded sequence
    for (c): the ring's inputs, the INT8 ring's at the shards' dequantized
    K/V, and context parallelism's suffix q; each with its gradients and
    ring_grad_tolerances. {name: (grads, tolerances)} on the host."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import flash_attention
    from quantizedmha_tpu_torch.parallel import ring
    q, k, v, do = _cp_inputs(c, seed, dev)
    parts = [ring._ste_residuals(a, b, c["block_kv"])
             for a, b in zip(k.chunk(c["cp"], dim=2), v.chunk(c["cp"], dim=2))]
    k_deq, v_deq = (torch.cat([p_[i] for p_ in parts], dim=2) for i in (0, 1))
    del parts
    S, Sq = c["seq"], c["suffix"]
    out = {}
    for name, (qq, kk, vv, dd) in (("ring", (q, k, v, do)),
                                   ("ring_int8", (q, k_deq, v_deq, do)),
                                   ("context_parallel", (q[:, :, -Sq:].contiguous(), k, v,
                                                         do[:, :, -Sq:].contiguous()))):
        with torch.no_grad():
            o, lse = flash_attention(qq, kk, vv, causal=True, save_residuals=True,
                                     q_offset=S - qq.shape[2], kv_offset=0)
        xs = [x.detach().requires_grad_() for x in (qq, kk, vv)]
        grads = torch.autograd.grad(flash_attention(*xs, causal=True), xs, dd)
        tols = ring_grad_tolerances(qq, kk, vv, o, lse, dd, grads, S - qq.shape[2], c["cp"],
                                    rows=c["rows"])
        out[name] = ([x.cpu() for x in grads], [t.float().cpu() for t in tols])
        del o, lse, xs, grads, tols
        _empty_cache(dev)
    return out


def phase_train_parallel(st):
    """Training across ranks: one spawn of 4 ranks on GPU 0 over gloo
    (N processes time-share the card and every collective crosses the
    host: not multi-GPU speeds). The unsharded side first, then freed:
    (a)'s initial weights saved with CheckpointManager and its unsharded
    sgd_train_step (losses, first-step gradients, saved as a checkpoint),
    (b)'s unsharded forward and loss gradients. Then the ranks, then (c)'s
    unsharded references and tolerances, then rows 1, 5, 6 and 7 at the
    ranks' shapes. Gates in the docstring at the top of this file."""
    import tempfile
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.utils.checkpoint import CheckpointManager
    tp_ = TRAIN_PARALLEL
    a, b, c = tp_["dp_tp"], tp_["pp"], tp_["cp"]
    seed, lr, dev = tp_["seed"], tp_["lr"], st.get("device", "cuda")
    model = dataclasses.replace(llama.LlamaConfig.llama3_8b(), **tp_["model"])
    gc.collect()
    _empty_cache(dev)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cfg_a = dataclasses.replace(model, num_layers=a["layers"])
        params = llama.init_params(cfg_a, torch.Generator(device=dev).manual_seed(seed),
                                   device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        tokens_a = torch.randint(0, cfg_a.vocab_size, (a["dp"], a["tokens"]), generator=gen,
                                 device=dev, dtype=torch.int32)
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(d, "weights")).save(0, params)
        save_s = time.perf_counter() - t0
        loss0, grads = _ref_step(cfg_a, params, tokens_a, lr)
        CheckpointManager(os.path.join(d, "grads")).save(0, grads)
        del grads
        ref_losses = [loss0]
        for _ in range(a["steps"] - 1):
            _, loss = llama.sgd_train_step(cfg_a, params, tokens_a, lr)
            ref_losses.append(float(loss))
        del params
        gc.collect()
        _empty_cache(dev)

        cfg_b = dataclasses.replace(model, num_layers=b["layers"])
        params = llama.init_params(cfg_b, torch.Generator(device=dev).manual_seed(seed),
                                   device=dev)
        tokens_b = torch.randint(0, cfg_b.vocab_size, (b["batch"], b["seq"]), generator=gen,
                                 device=dev, dtype=torch.int32)
        leaves = llama.float_leaves(params)
        logits = llama.forward(cfg_b, leaves, tokens_b)
        loss_b = _pp_loss(logits, tokens_b)
        loss_b.backward()
        per = cfg_b.num_layers // b["pp"]
        stages = [{k: torch.stack([r.grad for r in rows[s * per:(s + 1) * per]]).cpu()
                   for k, rows in leaves["layers"].items()} for s in range(b["pp"])]
        torch.save({"logits": logits.detach().cpu(), "stages": stages},
                   os.path.join(d, "pp_ref.pt"))
        del params, leaves, logits, stages
        gc.collect()
        _empty_cache(dev)
        ref_s = time.perf_counter() - t_phase

        job = dict(name="train", kind="train_parallel", device=dev,
                   dp_tp=dict(cfg=cfg_a, c=a, lr=lr, granule=tp_["granule"],
                              weights=os.path.join(d, "weights"), grads=os.path.join(d, "grads"),
                              tokens=tokens_a.cpu()),
                   pp=dict(cfg=cfg_b, c=b, seed=seed, tokens=tokens_b.cpu(),
                           ref=os.path.join(d, "pp_ref.pt")),
                   cp=dict(c=c, seed=seed + 2))
        t0 = time.perf_counter()
        ranks = [r["train"] for r in _spawn_ranks([job], tp_["world"], tp_["timeout_s"])]
        spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp_ref = _cp_reference(c, seed + 2, dev)
    cp_ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shapes = _train_parallel_kernels(c) if dev == "cuda" else {}  # the kernels need the card
    kernels_s = time.perf_counter() - t0

    # (a) DP x TP
    A = [r["dp_tp"] for r in ranks]
    rel_tol, grad_tol = tp_["loss_rel_tol"], tp_["grad_rel_tol"]
    L_a = cfg_a.num_layers
    want_a = {"flash_fwd[bf16]": L_a * a["steps"], "flash_bwd_dkv": L_a * a["steps"],
              "flash_bwd_dq": L_a * a["steps"], "flash_int8_fwd[int8_p]": 0}
    # The loss: step 1 (the same weights on both sides) within rel_tol of
    # the unsharded step's; a later step may move further by what the
    # earlier updates moved it: each update's gradients are within
    # grad_tol of the unsharded ones, so the loss change each caused is
    # within grad_tol of the unsharded change.
    drift = [0.0]
    for x, y in zip(ref_losses, ref_losses[1:]):
        drift.append(drift[-1] + grad_tol * abs(y - x))
    loss_bound = [rel_tol * abs(y) + dr for y, dr in zip(ref_losses, drift)]
    loss_rel = [max(abs(x - y) / bnd for x, y, bnd in zip(r["losses"], ref_losses, loss_bound))
                for r in A]
    gates_a = {
        "loss_vs_unsharded": max(loss_rel) <= 1.0,
        "ranks_same_loss": all(r["losses"] == A[0]["losses"] for r in A),
        "loss_falling": all(y < x for x, y in zip(A[0]["losses"], A[0]["losses"][1:])),
        "grads_vs_unsharded": all(max(r["grad_rel"].values()) <= grad_tol for r in A),
        "weights_finite": all(r["weights_finite"] for r in A),
        "launches": all(r["launches"] == want_a for r in A),
        "audit_exact": all(r["audit"]["exact"] and r["audit"]["every_step"] for r in A),
        "audit_by_axis": all(r["audit"]["by_axis"] == r["audit"]["want_by_axis"]
                             and r["audit"]["bytes_by_axis"] == r["audit"]["want_bytes_by_axis"]
                             for r in A)}
    # A planted fault is caught when it fails the gradient gate on a rank.
    faults = {name: {"max_grad_rel": max(r["faults"][name]["max_grad_rel"] for r in A),
                     "caught": any(r["faults"][name]["max_grad_rel"] > grad_tol for r in A)}
              for name in A[0]["faults"]}

    # (b) PP
    B_ = [r["pp"] for r in ranks]
    want_b = {"flash_fwd[bf16]": per * b["n_micro"], "flash_bwd_dkv": per * b["n_micro"],
              "flash_bwd_dq": per * b["n_micro"], "flash_int8_fwd[int8_p]": 0}
    gates_b = {
        "logits_vs_unsharded": all(r["rel_vs_unsharded"] <= 0.25 for r in B_),
        "ranks_same_logits": len({r["logits_sha1"] for r in B_}) == 1,
        "grads_vs_unsharded": all(max(r["grad_rel"].values()) <= grad_tol for r in B_),
        "grads_finite": all(r["grads_finite"] for r in B_),
        "launches": all(r["launches"] == want_b for r in B_)}
    faults["pipeline stage drops microbatch 0's gradient"] = {
        "max_grad_rel": max(r["fault_max_grad_rel"] for r in B_),
        "caught": any(r["fault_max_grad_rel"] > grad_tol for r in B_)}

    # (c) CP
    n, shard = c["cp"], c["seq"] // c["cp"]
    C = [r["cp"] for r in ranks]

    def held(name, got_of, ref_name=None):
        """err_over_tol of every rank's (dq, dk, dv) against its shard of the
        unsharded reference's gradients, within ring_grad_tolerances."""
        grads, tols = cp_ref[ref_name or name]
        worst = 0.0
        for i, r in enumerate(C):
            got = got_of(r)
            for j, (gg, ref_g, tol) in enumerate(zip(got, grads, tols)):
                if not (j == 0 and name.startswith("context")):
                    ref_g, tol = (x.chunk(n, dim=2)[i] for x in (ref_g, tol))
                worst = max(worst, err_over_tol(gg.to(dev), ref_g.to(dev), tol.to(dev).double()))
        return worst
    ratios_c = {"ring": held("ring", lambda r: r["ring"]["grads"]),
                "ring_int8": held("ring_int8", lambda r: r["ring_int8"]["grads"]),
                "context_parallel": held("context_parallel",
                                         lambda r: r["context_parallel"]["grads"])}
    int8_bits = all(all(torch.equal(x, y) for x, y in zip(r["ring_int8"]["grads"],
                                                           r["ring_at_dequantized"]["grads"]))
                    for r in C)
    want_c = {"ring": {"flash_fwd[bf16]": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                       "flash_int8_fwd[int8_p]": 0},
              "ring_int8": {"flash_fwd[bf16]": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                            "flash_int8_fwd[int8_p]": n},
              "ring_at_dequantized": {"flash_fwd[bf16]": n, "flash_bwd_dkv": n,
                                      "flash_bwd_dq": n, "flash_int8_fwd[int8_p]": 0},
              "context_parallel": {"flash_fwd[bf16]": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1,
                                   "flash_int8_fwd[int8_p]": 0}}
    gates_c = {"grads_vs_unsharded": max(ratios_c.values()) <= 1.0,
               "int8_ste_equals_float_ring_at_dequantized": int8_bits,
               "launches": all(r[k]["launches"] == w for r in C for k, w in want_c.items())}
    fault_rot = held("ring", lambda r: r["fault_rotation_right"])
    faults["ring gradient rotation sent right"] = {"err_over_tol": fault_rot,
                                                   "caught": fault_rot > 1.0}
    ste_bits = all(all(torch.equal(x, y) for x, y in zip(r["fault_ste_raw"],
                                                         r["ring_at_dequantized"]["grads"]))
                   for r in C)
    faults["INT8 straight-through backward at the raw K/V"] = {
        "err_over_tol": held("ring_int8", lambda r: r["fault_ste_raw"]),
        "caught": not ste_bits}

    kernel_ok = all(e["err_over_tol"] <= 1.0 for per_k in shapes.values() for e in per_k.values())
    launches = {}
    for name in _train_kernels():
        launches[name] = (A[0]["launches"][name] + B_[0]["launches"][name]
                          + sum(C[0][k]["launches"][name] for k in want_c))
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    st["train_parallel_shapes"] = shapes
    ok = (all(gates_a.values()) and all(gates_b.values()) and all(gates_c.values())
          and all(f["caught"] for f in faults.values()) and kernel_ok)
    for name, f in faults.items():
        print(f"chip_smoke train_parallel: planted fault ({name}) "
              f"{'caught' if f['caught'] else 'NOT caught'}", flush=True)
    emit({"phase": "train_parallel", "ok": ok, "model": "llama3_8b",
          "transport": f"{tp_['world']} processes time-sharing one card, gloo through the host",
          "dp_tp": {"dp": a["dp"], "tp": a["tp"], "layers": L_a, "tokens_per_dp_rank": a["tokens"],
                    "steps": a["steps"], "lr": lr, "gates": gates_a, "losses": A[0]["losses"],
                    "unsharded_losses": ref_losses, "loss_err_over_bound": max(loss_rel),
                    "loss_bound": loss_bound, "loss_rel_tol": rel_tol, "max_grad_rel": max(max(r["grad_rel"].values())
                                                                 for r in A),
                    "grad_rel_tol": grad_tol, "audit": A[0]["audit"],
                    "per_rank": [{"coords": r["coords"], "step_ms": [x * 1e3 for x in r["step_s"]],
                                  "peak_mem_gb": r["peak_mem_gb"], "restore_s": r["restore_s"],
                                  "collective_host_s": r["audit"]["collective_host_s"]}
                                 for r in A],
                    "checkpoint_save_s": save_s},
          "pp": {"pp": b["pp"], "layers": cfg_b.num_layers, "batch": b["batch"], "seq": b["seq"],
                 "microbatches": b["n_micro"], "gates": gates_b,
                 "rel_vs_unsharded": max(r["rel_vs_unsharded"] for r in B_),
                 "max_grad_rel": max(max(r["grad_rel"].values()) for r in B_),
                 "per_rank": [{k: r[k] for k in ("stage", "run_s", "peak_mem_gb", "loss")}
                              for r in B_]},
          "cp": {"cp": n, "seq": c["seq"], "per_rank_tokens": shard, "block_kv": c["block_kv"],
                 "suffix": c["suffix"], "gates": gates_c, "grad_err_over_tol": ratios_c,
                 "wall_s": {k: C[0][k]["wall_s"] for k in want_c}},
          "planted_faults": faults, "rank_shapes": shapes, "launches": launches,
          "reference_s": ref_s, "spawn_s": spawn_s, "cp_reference_s": cp_ref_s,
          "kernels_s": kernels_s, "phase_s": time.perf_counter() - t_phase, "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("train_parallel phase failed its checks")


_RANK_JOBS["train_parallel"] = _rank_train_parallel


def _dequantized(params, dtype):
    """params with every QuantizedWeight4 layer stack replaced by its
    dequantized weights as plain `dtype` tensors, one layer at a time."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import QuantizedWeight4, dequantize_weight4
    layers = {}
    for k, v in params["layers"].items():
        if isinstance(v, QuantizedWeight4):
            plain = torch.empty(v.shape, dtype=dtype, device=v.packed.device)
            for i in range(plain.shape[0]):
                plain[i] = dequantize_weight4(v.layer(i)).to(dtype)
            v = plain
        layers[k] = v
    return dict(params, layers=layers)


W4_SERVE = dict(prompt_len=512, max_new=64, chunk=16)  # the JAX bench's defaults
W4_PEAK_HEADROOM_GB = 2.0  # activations and prefill dequant transients


def phase_serve_w4(st):
    """w4a16 serving of "llama3-8b-shape-int4-lmh8" through the benchmark's
    run_decode_bench at batch 1, 8 and 32."""
    import torch
    from quantizedmha_tpu_torch.harness import serving_bench
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import w4_matmul as w4
    from quantizedmha_tpu_torch.quant.weights import (
        fuse_w4_projections,
        quantize_llama_params,
        weight_bytes,
    )
    from quantizedmha_tpu_torch.serving import llama_adapter

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attention_impl="flash_int8")
    L = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_llama_params(llama.init_params(cfg, gen, device="cuda"), bits=4,
                                   group=128, packing="halves", lm_head_bits=8)
    params = dict(params, layers=fuse_w4_projections(params["layers"]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    wbytes = weight_bytes(params)

    # A 64-token prefill (R = 64: the kernel's side of _W4_DECODE_ROWS)
    # against the same model with the dequantized weights as plain bf16
    # tensors: the same weights, summed in another order.
    toks = torch.randint(1, cfg.vocab_size, (1, 64), generator=gen, device="cuda",
                         dtype=torch.int32)
    w4.W4_MATMUL.reset()
    logits, _, _ = llama_adapter.prefill_at(cfg, params, toks, 63)
    prefill_launches = w4.W4_MATMUL.launches
    plain = _dequantized(params, cfg.dtype)
    ref = llama.forward(cfg, plain, toks)[:, -1]
    del plain
    torch.cuda.empty_cache()
    rel = ((logits - ref).abs().max() / ref.std()).item()
    finite = bool(torch.isfinite(logits).all().item())

    kernels = {"w4_matmul": w4.W4_MATMUL, "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P, "paged_decode": dec.PAGED_DECODE}
    rows, ok = [], finite and rel <= 0.25 and prefill_launches == 4 * L
    for batch in (1, 8, 32):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for kern in kernels.values():
            kern.reset()
        row = serving_bench.run_decode_bench(cfg, params, batch=batch, **W4_SERVE)
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernels.items()}
        steps = row["decode_steps"]
        want = {"w4_matmul": 4 * L * steps, "flash_int8_fwd[int8_p]": L * (batch + 1),
                "flash_int8_fwd[bf16_p]": 0, "paged_decode": L * steps}
        mpps = -(-(W4_SERVE["prompt_len"] + W4_SERVE["max_new"] + W4_SERVE["chunk"] + 1) // 128)
        cache_gb = (batch * mpps + 2) * L * 2 * cfg.num_kv_heads * (128 * cfg.hd + 4) / 1e9
        extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        row.update(launches=launches, launches_expected=want, cache_gb=cache_gb,
                   peak_extra_gb=extra_gb,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        row_ok = (launches == want and row["requests_failed"] == 0
                  and row["tokens_per_request"] == [W4_SERVE["max_new"]]
                  and extra_gb <= cache_gb + W4_PEAK_HEADROOM_GB)
        row["ok"] = row_ok
        ok = ok and row_ok
        rows.append(row)
        for name, n in launches.items():
            st["launches"][name] = st["launches"].get(name, 0) + n
    if st.get("profile"):
        for batch in (8, 32):
            emit({"phase": "serve_w4_profile", "batch": batch,
                  **_profile_w4(cfg, params, batch)})
    emit({"phase": "serve_w4", "ok": ok, "model": "llama3-8b-shape-int4-lmh8",
          "layers": L, "weights_gb": wbytes / 1e9, "init_s": init_s,
          "prefill64_w4_launches": prefill_launches,
          "prefill64_logits_rel_err_vs_bf16_dequant": rel, "rel_err_tol": 0.25,
          "peak_headroom_gb": W4_PEAK_HEADROOM_GB, "sweep": rows})
    if not ok:
        raise AssertionError("serve_w4 phase failed its checks")


def _profile_w4(cfg, params, batch):
    """Profiled full-batch decode chunks of the w4 model at `batch`."""
    import numpy as np
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    page, new = 128, 4 * W4_SERVE["chunk"]
    mpps = -(-(W4_SERVE["prompt_len"] + new + W4_SERVE["chunk"] + 1) // page)
    ecfg = EngineConfig(num_pages=batch * mpps + 2, page_size=page, max_batch=batch,
                        max_pages_per_seq=mpps, prefill_buckets=(W4_SERVE["prompt_len"],),
                        max_new_tokens=new, decode_chunk=W4_SERVE["chunk"])
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, W4_SERVE["prompt_len"]).tolist()
               for _ in range(batch)]
    return _profile_decode_chunk(eng, prompts, new)


def _host_profile(eng, steps):
    """One engine step under cProfile: the host's time a decode step by
    function. `own` ranks own time (a C call such as a torch op is its own
    entry; a ctypes launch counts in its caller), `port` the port's
    functions by cumulative time with their calls a step, `c_share` the
    share of own time spent in C calls. cProfile slows every Python
    call, so its shares, not its times, carry over to an untraced step."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    eng.step()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    total = sum(v[2] for v in stats.values())

    def row(f, v, t):
        fn = f[2] if f[0] == "~" else f"{os.path.basename(f[0])}:{f[1]}({f[2]})"
        return {"fn": fn[:90], "calls": v[1] / steps, "ms": t * 1e3 / steps,
                "share": t / total, "us_per_call": t * 1e6 / max(v[1], 1)}
    own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:16]
    port = sorted(((f, v) for f, v in stats.items() if "quantizedmha_tpu_torch" in f[0]),
                  key=lambda kv: -kv[1][3])[:16]
    return {"wall_ms_per_step": wall * 1e3 / steps, "own_ms_per_step": total * 1e3 / steps,
            "c_share": sum(v[2] for f, v in stats.items() if f[0] == "~") / total,
            "own": [row(f, v, v[2]) for f, v in own],
            "port": [row(f, v, v[3]) for f, v in port]}


def _kernel_groups(prof):
    """Device kernels of a torch.profiler window: ({name: (us, launches)},
    {KERNEL_GROUPS group or "other": (us, launches)}, busy seconds), by
    profiling/trace_summary.py's grouping."""
    from torch.autograd import DeviceType
    from quantizedmha_tpu_torch.profiling.trace_summary import group_kernels
    return group_kernels((e.name, e.time_range.elapsed_us()) for e in prof.events()
                         if e.device_type == DeviceType.CUDA)


def _profile_prefill(fn):
    """Where one prefill's device time goes: fn() under torch.profiler
    between two synchronizes; kernels grouped by KERNEL_GROUPS, the eight
    longest by name, wall and busy ms, and the idle share 1 - busy / wall
    (tracing slows the host, so an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, by_group, busy_s = _kernel_groups(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"traced_wall_ms": wall * 1e3, "device_busy_ms": busy_s * 1e3,
            "device_idle_share_traced": 1.0 - busy_s / wall,
            "groups": {g: {"ms": t / 1e3, "launches": n}
                       for g, (t, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0])},
            "top_kernels": [{"kernel": k[:80], "ms": t / 1e3, "launches": n}
                            for k, (t, n) in top]}


def _profile_decode_chunk(eng, prompts, max_new):
    """Where a full-batch decode chunk's time goes. One engine step
    (decode_chunk steps, one host sync) runs untraced, the next under
    torch.profiler, a third under cProfile (`host`); the first two are
    timed on the host clock and with CUDA events. The device kernels of
    the traced window are grouped by name, and its idle share is 1 -
    their busy time / that same window's CUDA-event time (tracing slows
    the host, so this share is an upper bound; the untraced window's
    times stand beside it). Needs four chunks of max_new."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.add_request(p, max_new=max_new)
    eng.step()  # admissions + the first chunk, outside both windows

    def window():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        eng.step()
        end.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, start.elapsed_time(end) / 1e3

    untraced_wall, untraced_events = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall, traced_events = window()
    steps = eng.ecfg.decode_chunk
    host = _host_profile(eng, steps)
    eng.run()
    by_name, by_group, busy_s = _kernel_groups(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"chunk_steps": steps,
            "untraced_wall_ms_per_step": untraced_wall * 1e3 / steps,
            "untraced_events_ms_per_step": untraced_events * 1e3 / steps,
            "traced_wall_ms_per_step": traced_wall * 1e3 / steps,
            "traced_events_ms_per_step": traced_events * 1e3 / steps,
            "device_busy_ms_per_step": busy_s * 1e3 / steps,
            "device_idle_share_traced": 1.0 - busy_s / traced_events,
            "groups_per_step": {g: {"ms": t / 1e3 / steps, "launches": n / steps}
                                for g, (t, n) in sorted(by_group.items(),
                                                        key=lambda kv: -kv[1][0])},
            "top_kernels_per_step": [{"kernel": k[:80], "ms": t / 1e3 / steps,
                                      "launches": n / steps} for k, (t, n) in top],
            "host": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also trace one full-batch decode chunk of the serve, "
                         "serve_w4 and serve_mixed phases, serve's 2048-token prefill "
                         "bench, serve_flash's bucketed and chunked prefills and one "
                         "train step, with torch.profiler")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # The package under test is the one beside this script, never a copy
    # installed elsewhere.
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "quantizedmha_tpu_torch", "__init__.py")):
        print("chip_smoke: the port package is missing beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import quantizedmha_tpu_torch  # noqa: F401
    if "build" not in phases:
        phases.insert(0, "build")
    if "harness" in phases and "solve" not in phases:
        phases.append("solve")  # the harness phase holds its times to solve's
    st = {"launches": {}, "launches_d256": {}, "launches_d256_f32": {}, "profile": args.profile,
          "keep_serve_params": "serve_w8a8" in phases}
    seconds = {}
    ran = False
    try:
        for name in PHASES:
            if name not in phases:
                continue
            t0 = time.perf_counter()
            try:
                globals()[f"phase_{name}"](st)
            except Exception:
                traceback.print_exc()
                emit({"phase": name, "ok": False})
                return 1
            seconds[name] = round(time.perf_counter() - t0, 1)
            if name == "build" and "faults" in phases and len(phases) > 2:
                # The faults phase's builds, behind the other phases (_FaultBuilds).
                st["fault_builds"] = _FaultBuilds(max(1, (os.cpu_count() or 8) - 2), nice=True)
            if name == "build" and "kernels" in phases:
                # The d=256 INT8 flash walks' per-score work emptied, for the
                # CUDA cores' bound (_cuda_core_bounds), behind the other phases.
                from quantizedmha_tpu_torch.harness import sass_count
                from quantizedmha_tpu_torch.ops import cuda_lib
                st["sass_build"] = sass_count.start_emptied(
                    cuda_lib.CSRC, cuda_lib.BUILD_DIR / "sass_emptied", nice=True)
        ran = True
    finally:
        if "fault_builds" in st:
            st.pop("fault_builds").stop()
        if "sass_build" in st and not ran:
            from quantizedmha_tpu_torch.harness import sass_count
            sass_count.stop(st.pop("sass_build"))
    emit({"phase_seconds": seconds, "total": round(sum(seconds.values()), 1)})
    if "kernels" in st:
        _cuda_core_bounds(st)
        entries = []
        for name, c in st["kernels"].items():
            e = {k: c[k] for k in ("name", "route", "source", "replaces", "max_abs_err",
                                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            e.update({k: c[k] for k in ("also_replaces", "mqa", "serve_flash", "library_note",
                                        "library_backend", "library_f32", "solve", "serve_w4",
                                        "prefill_bench", "gemma2", "train_f32") if k in c})
            if "gemma2" in c:  # its launches: serve_hybrid's at head_dim 256 (f32:
                # serve_gemma2_f32's, in each f32 sub-entry)
                e["gemma2"] = dict(c["gemma2"], launches=st["launches_d256"].get(name, 0))
                for kind, sub in c["gemma2"].items():
                    if kind.endswith("_f32"):
                        e["gemma2"][kind] = dict(
                            sub, launches=st["launches_d256_f32"].get(name, 0))
            if "mqa" in c:  # row 4: its launches at one kv head (serve_tp's tp=8 ranks)
                e["mqa"] = dict(c["mqa"], launches=st.get("launches_mqa", 0))
            for key in ("tp_shapes", "cp_shapes", "train_parallel_shapes"):  # a rank's shapes
                if name in st.get(key, {}):
                    e[key.replace("_shapes", "_rank")] = st[key][name]
            if "shapes" in c:
                e["shapes"] = [{k: s[k] for k in ("matmul", "rows", "ms", "wrapper_ms", "plain_ms",
                                                  "bound_ms", "library_ms")} for s in c["shapes"]]
            e["launches"] = st["launches"].get(name, 0)
            entries.append(e)
        emit({"kernels": entries})
        idle = [e["name"] for e in entries if e["launches"] == 0]
        if ({"solve", "int8_modes", "serve", "serve_w4", "serve_flash", "serve_mixed",
             "serve_hybrid", "serve_hybrid_mixed", "serve_gemma2_f32", "serve_spec", "serve_hf",
             "train", "train_gemma2", "train_gemma2_f32"}
                <= set(phases) and idle):
            print(f"chip_smoke: kernels never launched on a main path: {idle}",
                  file=sys.stderr)
            return 1
    print(st["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
