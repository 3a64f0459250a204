"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), torch and CUDA versions.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Runs each kernel at every shape its main path gives it and holds its
   output, bit for bit, against its plain-torch twin on the same inputs;
   times kernel, twin and a PyTorch library yardstick (fp32
   ``torch.matmul`` / ``F.conv2d`` of the unpacked ±1 operands, TF32
   off; none for ``pack_rows``) with CUDA events. The slice-1 kernels
   run at the batch-32 serving shapes, ``xnor_gemm`` also at the eight
   products of Table 2's PAPER_KERNEL forward at its batch of 64 (these
   times make its total; the batch-32 head is given apart), beside a bf16
   ``torch.matmul`` of the same ±1 operands (``library_bf16_ms``, a timing
   yardstick only). The two megakernels run at the
   three conv-stage shapes (and once more at batch 3) and at the FC
   trunk (batch 32 and masked tails of 1, 3 and 13 columns); beside
   them the slice-1 per-layer kernels over the same layers are timed.
   The unfused PACKED kernels run at the eight binary layers of the
   Table 2 forward at its batch of 64 (these times make their totals),
   and again at batch 32: ``pack_rows`` on the transposed patch matrix
   it reads in place, timed with a cold L2 as its HBM bound assumes;
   ``direct_conv`` at the five convs; ``unpack_gemm`` on ±1 input
   (exact) and on real input in [-1, 1], held within rtol 1e-5 / atol
   1e-4 of the float64-accumulated dot, and the same at jamba's decode
   shape (one packed [8192, 8192] expert, bf16 X [8192, 4]; yardstick
   bf16 ``torch.matmul``; not summed). The three conv kernels are timed beside
   a bf16 ``F.conv2d`` of the same ±1 operands (``library_bf16_ms``, a
   timing yardstick only: its outputs round).
   Before them, the rates of the three inner loops a packed ±1
   product can run (``XNOR_LOOP_BODY``: popc on the CUDA cores, 1-bit and
   int8 ``mma.sync``) are measured and stored.
4. Serves 12 ragged requests (1-8 images) on the trained checkpoint
   ``tests/golden/bnn_trained_ckpt.npz`` through ``ServingEngine
   (engine="xnor")`` for each ``conv_impl``, and through
   ``ContinuousServingEngine(engine="megakernel")`` with a
   ``FallbackPolicy`` holding both param sets, and holds every request's
   logits, bit for bit, against the ``xla`` (plain-torch) forward of
   the same images on the card. The launch counters are reset just
   before each path's engine is built and read just after its drain:
   each path must have launched exactly its own kernels per forward
   (one per layer on the ``xnor`` paths, 3 conv stages + 1 chain on the
   megakernel path; the engines serve from CUDA graphs, so each warmed
   shape runs one eager forward before its capture and one replay at
   warmup, and each served batch one replay, whose launches the
   executor counts), and no engine failover may be recorded. Times the
   batch-32 forward of each path. Then (4a) every executor a deployment
   can capture, each engine x conv_impl x bucket of the default ladder
   and each extent class of the continuous engine for every rung of its
   ladder, replays logits bit-identical to the eager forward, with one
   capture a shape warmed and none after; (4b) every tiling
   ``kernels.autotune`` can select, at each tunable kernel's Table 2 and
   served shapes, is bit-identical to the twin (clusters whose shared
   memory exceeds a block's are refused and counted), then ``tune`` runs
   once per kernel at its batch-32 served shape and
   ``tune_serving_blocks`` at bucket 32 for xnor/direct, xnor/im2col and
   the megakernel, each winner printed beside the ``AUTO`` time; (4c)
   the CLI's ``run_sustained`` serves ``LOAD_RATE`` requests/s for
   ``LOAD_SECONDS`` s on the continuous megakernel engine and the
   xnor/direct bucket engine, every answered request's logits checked,
   and prints p50/p99 latency, images/s and the pad-row fraction; (4d)
   a 32-image request through each engine with graphs, submit to
   logits, beside the eager and raw-graph forward times.
5. Table 2 on the card: ``bnn_apply`` of the six presets of
   ``repro_torch.configs.bnn_cifar`` on the trained checkpoint at batch
   64. The launch counters are reset just before each preset's checked
   forward and read just after: each preset must launch exactly its
   kernels (PAPER_KERNEL 8 ``pack_rows`` + 8 ``xnor_gemm``,
   DIRECT_KERNEL 5 ``direct_conv`` + 3 + 3, MXU_KERNEL 8
   ``unpack_gemm``, the others none), and the output of each of those
   calls must equal its plain twin on the call's own inputs. A profiler
   failure leaves the breakdown "not measured"; a kernel or wrapper
   error fails the run. The four PACKED presets and
   SIMULATION must give logits bit-identical to the fused ``xla``
   forward of the same images on the card; CONTROL_GROUP (float
   layers, zero-padded borders: other logits) is held to its CPU
   forward on 4 of the images. Prints each preset's device (graph) and
   eager ms, weight bytes, and the CONTROL_GROUP / PAPER_KERNEL ratio.
6. Serves one full-width period of jamba-1.5-large-398b (8 of its 72
   layers; every width, all 16 experts, vocab 65536) from 1-bit packed
   weights through ``repro_torch.launch.serve.serve_config``: batch 4,
   a 512-token prompt, 8 greedy tokens (``jamba_phase``). The prefill
   must launch ``ssm_scan_chunk`` exactly 14 times (7 mamba layers x 2
   chunks) and nothing else, each decode step nothing; every scan call
   of the prefill is held within rtol/atol 1e-5 of its twin on its own
   inputs, and the logits of every step against the same model run
   with the twin in place of the kernel (``JAMBA_LOGIT_TOL``). Prints
   packed vs bf16 weight bytes, prefill and decode ms (CUDA events),
   peak memory and profiles. (Phase 3 also runs ``ssm_scan_chunk`` at
   the prefill's chunk, a short prompt's and a ragged case, within
   rtol/atol 1e-5 of its twin. It also runs ``flash_attention`` at
   smollm-360m's training shape [60, 4096, 64] in bf16, in float32, at
   a ragged [3, 1000, 64] and at pixtral-12b's [64, 4096, 128] in bf16,
   against its twin with the kernel's KV tile,
   with ``F.scaled_dot_product_attention`` as the yardstick, and
   ``mlstm_chunked`` at xlstm-1.3b's [8, 4096, 1024, 1024], chunk 256, and
   on one chunk (``attention_phase``).)
7. The LM training forward (``lm_phase``): ``Model.loss`` of smollm-360m
   (32 layers, batch 4 x 4096) and xlstm-1.3b (one 8-layer period of its
   48 layers, batch 2 x 4096) at full width under ``train_policy()``, on
   random float32 params and a batch of ``synthetic_lm_batches``. The
   launch counts are reset just before each loss forward and read after
   it: 32 ``flash_attention`` / 7 ``mlstm_chunked`` launches and nothing
   else; every kernel call of
   that forward is held against its twin on its own inputs; loss and
   logits are held to the same model with the twins in place of the
   kernels (``LM_CASES``, ``LM_LOSS_TOL``, ``LM_LOGIT_TOL``,
   ``LM_F32_LOSS_TOL``, ``LM_F32_LOGIT_TOL``). Prints the loss, the forward's ms (CUDA
   events), peak memory and a profile.
8. The BNN's train-to-serve loop at full width (``train_phase``):
   ``train_bnn`` with ``BNNTrainerConfig()``'s defaults (200 STE steps at
   batch 64, checkpoints every 50) must learn (the back-half mean loss
   0.5 below the first, held-out accuracy above chance, latents in
   [-1, 1], running BN statistics moved) and launch no kernel; one
   step's time by CUDA events, images/s, peak memory and the device's
   busy share (``torch.profiler``) beside the float32 bound
   (``train_step_flops``). The run resumed from step 150 must end
   bit-identical; ``pack_trained_params`` must verify every engine on 64
   held-out images for it and for a 20-step ``use_scale`` run; its
   sign-form checkpoint, loaded on the card, serves 12 requests through
   the ``xnor``/direct and continuous megakernel engines, each equal to
   the float-boundary forward of its images alone. The phase's launches
   are the path ``bnn_train_export``.
9. The BNN served over a mesh of replicas (``mesh_phase``): every card
   when there are two or more, else 4 replicas sharing the card, each with
   its own stream, graph pool and CUDA graphs. The xnor/direct bucket
   engine serves 12 requests bit-identical to the single-device ``xla``
   forward, with exactly k x the path's kernels a forward; the continuous
   megakernel engine loses replica 1 at dispatch 2 (an injected
   ``device_loss``), shrinks to the survivors and re-dispatches, then
   shrinks again when replica 1 stops beating, every answer bit-identical
   and none failed; a batch-32 dispatch through k graphs and through one
   is timed on the host clock. The phase's launches are the path
   ``bnn_serve_mesh``.
10. The BNN trained over a mesh of replicas, under chaos
   (``train_resilient_phase``): 8 replicas (every card when there are 8 or
   more, else round-robin over the cards), batch 64. The data-parallel
   step on one shard equals the single-device step bit for bit; each
   gradient compression (float32, EF int8, 1-bit EF sign-SGD) trains 60
   steps and passes ``benchmarks/train_bench.py``'s gates, with its step
   ms, images/s and busy share; sign-SGD replays bit for bit.
   ``benchmarks/train_chaos.py``'s full scenario (preemption, torn
   checkpoint, NaN batch, a lost host 8 -> 4) through
   ``train_bnn_resilient`` holds its six gates, and a straggler is evicted
   (8 -> 4). The chaos run's params export under the probe. The phase's
   launches (the export's) are the path ``bnn_train_resilient``.
11. The LM trainer (``lm_bwd_kernel_phase``, ``lm_train_phase``): the
   three backward kernels (``flash_attention_bwd``, ``ssm_scan_chunk_bwd``,
   ``mlstm_chunked_bwd``) at their training shapes against their twins on
   the same saved tensors (``BWD_F32_TOL``, ``BWD_BF16_ULPS``), each
   repeating bit for bit over two calls, timed beside their bounds, twins
   and, for flash, SDPA's backward (flash also at a head width of 128),
   and one scan backward call's peak memory; then
   smollm-360m (32 layers, batch 4 x 4096) and xlstm-1.3b (one 8-layer
   period, batch 2 x 4096) trained through ``launch.train.train`` under
   ``train_policy()``: the first step's loss and per-leaf gradients held
   to the twins' (``LM_GRAD_TOL``), the launch counts of every step (with
   remat each period's forward runs twice), ms a step, tokens/s, peak
   memory, and for smollm busy share and a profile (xlstm's step is not
   profiled: its sLSTM loop's ~10^5 launches cost the profiler ~90 s);
   the three smoke families must learn with ``quickstart.py``'s settings,
   and a run resumes from its checkpoint. The phase's launches are the
   path ``lm_train``.
12. The remaining LM families (``families_phase``): qwen2.5-3b (36
   layers), qwen2.5-32b, mistral-large-123b, moonshot-v1-16b-a3b (8
   layers each), arctic-480b (2 layers), pixtral-12b (8 layers, prompted
   with patch embeddings) and seamless-m4t-large-v2 (24 + 24 layers,
   frames and a token prompt), every width the published one, served
   from 1-bit packed weights through ``serve_config`` (bf16, batch 4, a
   512-token prompt, 8 greedy tokens): no kernel launched (the ``xla``
   engine, experts one by one, a KV cache, as the JAX package's
   ``serve_policy``), packed and bf16 weight bytes, prefill and decode
   ms (CUDA events), peak memory, a profile of the largest; in float32
   activations at batch 1 decode agrees with prefill (``DECODE_TOL``).
   Then seamless-m4t-large-v2 (all 48 layers) and pixtral-12b (2 layers)
   trained at batch 2 x 4096 as in phase 11, with exact flash launch
   counts (the decoder's causal self-attention; the encoder's and the
   cross-attention take the chunked path), and the seven smoke configs
   must learn. The phase's launches are the paths ``lm_families_serve``
   and ``lm_families_train``.

13. The dry run's counter and data-parallel LM training
   (``dryrun_dp_phase``): smollm-360m at full width (batch 4 x 4096, bf16,
   ``train_policy()``) takes one data-parallel step on 2 replicas sharing
   the card and one single-device step on the same params and batch; loss
   and reduced gradients agree within phase 11's first-step tolerances,
   and flash attention forward and backward launch exactly twice as often.
   The single-device step is counted by ``roofline.op_cost`` on the card
   and on meta (FLOPs, bytes and kernel calls equal) and its ms (CUDA
   events) printed beside the one-card roofline. The DP step's launches
   are the path ``lm_dp_train``.

14. Tensor parallelism over the model axis (``tp_phase``): qwen2.5-3b at
   its published widths, 8 of 36 layers (batch 2 x 4096, bf16,
   ``train_policy()``) takes one ``train.step.make_tp_train_step`` step on
   a (1, 2) ``("data", "model")`` mesh of two ranks sharing the card, the
   params laid out by the rule table, and one single-device step on the
   same params and batch: loss within ``LM_LOSS_TOL``, the gathered
   gradients (Adam's first moment) per leaf within phase 11's bf16
   ``LM_GRAD_TOL``, flash attention forward and backward launched exactly
   twice as often, each rank's param bytes the rule table's shard bytes,
   the TP step's collective bytes a device, as counted, the dry run's
   reckoning for the same mesh (``op_cost.collective_bytes`` plus
   ``collective_bytes_bwd``, kind by kind and direction by direction).
   Prints ms a step for both (CUDA events), their peak memory and the
   bytes by site. The TP step's launches are the path ``lm_tp_train``.

15. Expert parallelism over the model axis (``ep_phase``):
   moonshot-v1-16b-a3b at its published widths (64 experts of d_ff 1408,
   top-6), 2 of 48 layers (batch 2 x 4096, bf16, ``train_policy()``)
   takes one ``make_tp_train_step`` step on a (1, 2) mesh of two ranks
   sharing the card, each rank holding 32 experts, and one single-device
   step first; its first moment goes to the host and its trees leave the
   card before the EP step. Holds the loss and the balance loss within
   ``LM_LOSS_TOL``, the gathered gradients within the bf16
   ``LM_GRAD_TOL``, flash forward and backward exactly twice as often,
   rank bytes the rule table's, collective bytes the reckoning; prints ms
   a step, peak memory, bytes by site and the (token, slot) pairs routed
   to another expert than the single step's, layer by layer. arctic's
   smoke config (its dense residual beside the experts) takes the same
   two steps in float32. The EP step's launches are the path
   ``lm_ep_train``.

16. The model axis for the remaining layers (``ssm_tp_phase``), each part
   on a (1, 2) mesh of two ranks sharing the card against one device on
   the same params and inputs, each holding the rank bytes to the rule
   table's, the collective bytes a device as counted to the dry run's
   reckoning, and the scan, mLSTM and flash launches, forward and
   backward, to exactly twice the single device's: (a) jamba's mamba
   block at its published widths (d_model 8192, d_inner 16384, d_state
   16, dt rank 512, conv 4), batch 2 x 4096, bf16, ``train_policy()``,
   forward and backward under remat as a period runs it, the output, the
   input's gradient and every param's gradient within the bf16
   ``LM_GRAD_TOL``; (b) jamba's smoke config (attention, experts and mamba
   in one period), one ``make_tp_train_step`` step in float32; (c)
   xlstm-1.3b at its published widths (4 heads, mLSTM heads of 1024,
   vocab 50304), 8 of 48 layers, batch 2 x 4096, float32 activations;
   (d) seamless-m4t-large-v2 at its published widths (16 heads, d_ff
   8192, vocab 256206), 4 + 4 of 24 + 24 layers, batch 2 x 4096, bf16.
   Steps: loss within ``LM_LOSS_TOL``, the gathered first moments within
   ``LM_GRAD_TOL``. Prints each part's seconds, ms of the single and TP
   calls (CUDA events around the checked call) and the bytes by site. The
   parts' TP launches are the path ``lm_tp_ssm_train``.

17. Fully sharded data parallelism (``fsdp_phase``): one
   ``make_tp_train_step`` step on a (2, 2) ``("data", "model")`` mesh of
   four ranks sharing the card, every param and AdamW leaf split over
   ``data`` and ``model`` by the rule table and gathered over ``data`` a
   period at a time, against one single-device step on the same params
   and batch: (a) qwen2.5-3b as phase 14 runs it (8 of 36 layers, batch 2
   x 4096, bf16); (b) jamba's smoke config (attention, experts and mamba
   in one period), batch 8 x 64, float32. Each holds the loss within
   ``LM_LOSS_TOL``, the gathered first moments within ``LM_GRAD_TOL``,
   each device's param and optimizer bytes the rule table's blocks
   (``param_spec``, data axes included), the flash or scan launches,
   forward and backward, exactly four times the single device's, and the
   collective bytes a device as counted to the dry run's reckoning. (a)
   prints its ms a step and peak memory beside phase 14's (1, 2) step, and
   each device's at-rest bytes beside phase 14's ranks': on one card the
   four blocks add up to the whole model, so no saving shows there. The
   parts' launches are the path ``lm_fsdp_train``.

18. One process a device (``spmd_phase``; ``distributed.process_group``):
   processes spawned with ``torch.multiprocessing`` meet through a
   ``file://`` store under ``build/spmd`` and run the steps SPMD, each
   holding its own position's blocks, the collectives through
   ``torch.distributed``. (a) phase 14's qwen2.5-3b step on (1, 2) in two
   processes sharing the card (gloo, by the backend rule): the loss within
   ``LM_LOSS_TOL`` and the gathered first moment within the bf16
   ``LM_GRAD_TOL`` of phase 14's single-device step, its largest
   difference from phase 14's lockstep step printed (0 expected), each
   process's flash launches the single device's (16 forward, 8 backward),
   its param and optimizer bytes the rule table's, the counted collective
   bytes (the processes' mean) phase 14's reckoning; ms a step and peak
   memory per process. (c) phase 10's sign-SGD DP step, 3 steps in the same
   two processes: params, residual rows and metrics bit-identical to the
   lockstep step on two replicas. (b) phase 17 (a)'s step on (2, 2) in four
   processes, held as (a). (d) the backend rule refuses NCCL for two ranks
   on the one card; a world of one on NCCL runs the BNN's DP step bit for
   bit as ``make_train_step``. A process's failure fails the run. The
   processes' launches are the path ``lm_spmd_train``.

Every phase prints its seconds.

Last, prints a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}``.

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Per-shape details go to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8
# tensor-core ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# The ±1 products of the xnor kernels (2 ops each). NVIDIA publishes no
# 1-bit rate; this script's ``xnor_loop_rates`` measures the 1-bit
# ``mma.sync`` m16n8k256 (and.popc) at the int8 m16n8k32's instruction
# rate, with 8x its products, so their peak is taken as 8x int8's.
B1_OPS_PER_S = 8 * INT8_OPS_PER_S
# Float32 on the CUDA cores (pack_rows' compares), bf16 on the tensor
# cores (unpack_gemm: its ±1 operands are exact in bf16) and tf32 on the
# tensor cores (the mLSTM's 3xTF32 products, ``tc_bound_ms``), dense.
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# The scan's exps run on the special-function units: 16 MUFU.EX2 per clock
# per SM (CUDA C++ programming guide, arithmetic instruction throughput,
# compute capability 9.0), 132 SMs, at the 1.98 GHz boost clock.
MUFU_EX2_PER_S = 132 * 16 * 1.98e9
OPS_RATE = {"pack_rows": FP32_OPS_PER_S, "unpack_gemm": BF16_OPS_PER_S,
            "ssm_scan_chunk": MUFU_EX2_PER_S,
            "flash_attention": BF16_OPS_PER_S, "mlstm_chunked": FP32_OPS_PER_S,
            "flash_attention_bwd": BF16_OPS_PER_S,
            "ssm_scan_chunk_bwd": MUFU_EX2_PER_S,
            "mlstm_chunked_bwd": FP32_OPS_PER_S}
# Read between calls to time a kernel with a cold L2 (50 MB on the H100).
L2_FLUSH_BYTES = 128 * 2**20
BATCH = 32
CKPT = ROOT / "tests" / "golden" / "bnn_trained_ckpt.npz"
OUT_DIR = ROOT / "build"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 20, reps: int = 5, cold: bool = False) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events (median), so no host
    dispatch gap between launches is counted. ``cold``: each call follows
    a read of 128 MB (past the 50 MB L2), so its operands come from HBM,
    as its bytes bound assumes; the time of the reads alone, captured
    the same way, is subtracted."""
    if cold:
        flush_buf = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
        flush = flush_buf.sum

        def flushed():
            flush()
            fn()

        return graph_ms(flushed, iters, reps) - graph_ms(flush, iters, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int,
             rate: float = B1_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rand_words(gen: torch.Generator, shape, dev) -> torch.Tensor:
    w = torch.randint(0, 2**32, shape, generator=gen, dtype=torch.int64)
    return (w - ((w >> 31) << 32)).to(torch.int32).to(dev)


def rand_affine(gen: torch.Generator, m: int, k_bits: int, dev):
    """Per-row (a, b) whose sign threshold lands inside the dot's spread,
    so the packed outputs carry both bit values."""
    sign = torch.where(torch.rand(m, generator=gen) < 0.5, -1.0, 1.0)
    a = (0.5 + torch.rand(m, generator=gen)) * sign
    b = torch.randn(m, generator=gen) * (k_bits ** 0.5) * a.abs()
    return a.float().to(dev), b.float().to(dev)


def gemm_cases():
    """(label, M, KW, N, k_bits) of every GEMM the batch-32 forward runs:
    the head, fc0, fc1 and (conv_impl="im2col") the five binary convs."""
    n_img = BATCH
    fused = [("fc0", 1024, 256, n_img, 8192), ("fc1", 1024, 32, n_img, 1024)]
    for i, (h, cin, cout) in enumerate(
            [(32, 128, 128), (16, 128, 256), (16, 256, 256), (8, 256, 512),
             (8, 512, 512)], start=1):
        fused.append((f"conv{i}/im2col", cout, 9 * cin // 32, n_img * h * h,
                      9 * cin))
    return [("head", 10, 32, n_img, 1024)], fused


def paper_gemm_cases(batch: int):
    """(label, M, KW, N, k_bits) of the eight ``xnor_gemm`` products of
    Table 2's PAPER_KERNEL forward (unfused PACKED ``bnn_apply``) at
    ``batch``: the five im2col convs, fc0, fc1 and the head; k_bits =
    32 KW (``_packed_matmul``'s ``k_pad``)."""
    cases = [(label, d, 9 * c // 32, batch * h * h, 9 * c)
             for label, h, c, d in conv_cases()]
    return cases + [("fc0", 1024, 256, batch, 8192), ("fc1", 1024, 32, batch, 1024),
                    ("head", 10, 32, batch, 1024)]


def conv_cases():
    """(label, H, C, D) of every direct conv of the batch-32 forward."""
    return [("conv1", 32, 128, 128), ("conv2", 16, 128, 256),
            ("conv3", 16, 256, 256), ("conv4", 8, 256, 512),
            ("conv5", 8, 512, 512)]


def check_equal(name: str, label: str, got: torch.Tensor,
                want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {label}: {tuple(got.shape)}/{got.dtype} vs twin "
             f"{tuple(want.shape)}/{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    if err != 0:
        bad = int((got != want).sum().item())
        fail(f"{name} {label}: {bad} words differ from the plain twin "
             f"(max abs err {err})")
    return err


# The three inner loops a packed ±1 product can run on this card, each in
# registers (no loads), many independent accumulators a warp, so each runs
# at its instruction's issue ceiling: (a) xnor + popc + add on the CUDA
# cores (fused_gemm.cu before its tensor-core tile), (b) the 1-bit
# tensor-core product mma.sync m16n8k256 with and.popc or xor.popc, (c)
# int8 mma.sync m16n8k32 (on ±1 bytes: exact). Rates are bit products a
# second (one ±1 multiply-add each). Each variant is its own source, so
# one that ptxas refuses does not stop the others. {variant: (bit products
# a thread-iteration, loop body)}.
XNOR_LOOP_BODY = {
    "popc": (32 * 8, r"""
  unsigned acc[8] = {};
  unsigned x[8];
  for (int j = 0; j < 8; ++j) x[j] = seed * (2 * j + 3);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the word pair varies with the running count, so nothing of the
      // xnor and popc is loop-invariant
      asm volatile("{\n .reg .b32 t;\n xor.b32 t, %0, %1;\n not.b32 t, t;\n"
                   " popc.b32 t, t;\n add.u32 %0, %0, t;\n}\n"
                   : "+r"(acc[j]) : "r"(x[j]));
    }
  }
  unsigned s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j];"""),
    **{f"b1 {op}": (16 * 8 * 256 * 8 // 32, r"""
  int c[8][4] = {};
  const unsigned a0 = seed, a1 = seed * 3, a2 = seed * 5, a3 = seed * 7;
  const unsigned b0 = seed ^ 0x5555u, b1 = seed ^ 0xa5a5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.OP {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  unsigned s = 0;
  for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];""".replace(
        "OP", op)) for op in ("and.popc", "xor.popc")},
    "int8": (16 * 8 * 32 * 8 // 32, r"""
  int c[8][4] = {};
  const unsigned a0 = seed, a1 = seed * 3, a2 = seed * 5, a3 = seed * 7;
  const unsigned b0 = seed ^ 0x5555u, b1 = seed ^ 0xa5a5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  unsigned s = 0;
  for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];"""),
}
XNOR_LOOP_DIR = OUT_DIR / "xnor_loops"


def start_xnor_loop_build() -> dict:
    """One ``nvcc`` per inner loop of ``XNOR_LOOP_BODY``, started beside the
    main build: ``{variant: (so path, Popen)}``."""
    from repro_torch.kernels import build

    procs = {}
    for i, (variant, (_, body)) in enumerate(XNOR_LOOP_BODY.items()):
        d = XNOR_LOOP_DIR / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "loop.cu").write_text(
            "#include <cuda_runtime.h>\n"
            "__global__ void loop(unsigned* out, int iters) {\n"
            "  const unsigned seed = threadIdx.x * 2654435761u + blockIdx.x;\n"
            + body + "\n  out[blockIdx.x * blockDim.x + threadIdx.x] = s;\n}\n"
            'extern "C" int run_loop(unsigned* out, int blocks, int threads, '
            "int iters) {\n  loop<<<blocks, threads>>>(out, iters);\n"
            "  return static_cast<int>(cudaGetLastError());\n}\n")
        procs[variant] = (d / "loop.so", subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "loop.so"),
             str(d / "loop.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def xnor_loop_rates(procs: dict) -> dict:
    """Bit products a second of each inner loop at full occupancy (2 blocks
    of 256 threads an SM, CUDA events); a variant ptxas refuses is
    reported with the compiler's words. Also prints each rate."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 2 * sms, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    rates = {}
    for variant, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            rates[variant] = {"error": log.strip()[-600:]}
            print(f"  inner loop {variant}: not built ({log.strip()[-200:]})",
                  flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        lib.run_loop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
        run = lambda: lib.run_loop(out.data_ptr(), blocks, threads, iters)  # noqa: E731,B023
        if run():
            fail(f"inner loop {variant} did not launch")
        ms = time_ms(run, iters=3)
        bits = blocks * threads * iters * XNOR_LOOP_BODY[variant][0]
        rates[variant] = {"ms": ms, "bit_products_per_s": bits / ms * 1e3}
        print(f"  inner loop {variant:12s}: {bits / ms / 1e9:10.1f} T bit "
              f"products/s ({2 * bits / ms / 1e9:.1f} TOP/s at 2 ops each; "
              f"{blocks} blocks x {threads} threads, {ms:.3f} ms)", flush=True)
    return rates


def call_peak_bytes(dev, run) -> int:
    """Device memory one call allocates at its peak, above what was
    allocated before it (its outputs and scratch)."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = run()
    torch.cuda.synchronize(dev)
    del out
    return torch.cuda.max_memory_allocated(dev) - base


def repeats_exactly(kernel: str, label: str, run) -> bool:
    """Two calls on the same inputs give bit-identical outputs."""
    first = [t.clone() for t in run()]
    second = run()
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            fail(f"{kernel} {label}: output {i} differs between two calls on the "
                 f"same inputs ({int((a != b).sum())} elements)")
    return True


def kernel_phase(dev, paper_batch: int) -> tuple[dict, list]:
    from repro_torch.core import bitops
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0, "bytes": 0, "ops": 0}
              for k in ops.LAUNCHES}
    rows = []
    head, fused = gemm_cases()
    # (kernel, label, M, KW, N, k_bits, summed): the served head at batch
    # 32 apart; xnor_gemm's total is PAPER_KERNEL's eight products.
    cases = [("xnor_gemm", f"{label} b{BATCH}", *shape, False) for label, *shape in head]
    cases += [("xnor_gemm", f"{label} b{paper_batch}", *shape, True)
              for label, *shape in paper_gemm_cases(paper_batch)]
    cases += [("fused_xnor_gemm", label, *shape, True) for label, *shape in fused]
    for name, label, m, kw, n, k_bits, summed in cases:
        w = rand_words(gen, (m, kw), dev)
        x = rand_words(gen, (kw, n), dev)
        if name == "xnor_gemm":
            a = b = None
            run = lambda: ops.xnor_gemm(w, x, k_bits)  # noqa: E731
            twin = lambda: bitops.xnor_popcount_matmul(w, x, k_bits)  # noqa: E731
            out_bytes = m * n * 4
        else:
            a, b = rand_affine(gen, m, k_bits, dev)
            run = lambda: ops.fused_xnor_gemm(w, x, k_bits, a, b)  # noqa: E731
            twin = lambda: bitops.fused_xnor_layer(w, x, k_bits, a, b)  # noqa: E731
            out_bytes = -(-m // 32) * n * 4
        want = twin()
        err = check_equal(name, label, run(), want)
        # Yardstick: the same ±1 dot as an fp32 matmul (K words past
        # k_bits are xnor-neutral pads, none here: k_bits = 32*KW).
        wf = bitops.unpack_bits(w, axis=-1)
        xf = bitops.unpack_bits(x, axis=0)
        lib = lambda: torch.matmul(wf, xf)  # noqa: E731
        lib_bf16 = None
        if name == "xnor_gemm" and summed:
            # and in bf16 (a timing yardstick only: exact here, K <= 8192)
            wh, xh = wf.bfloat16(), xf.bfloat16()
            lib_bf16 = lambda: torch.matmul(wh, xh)  # noqa: E731
        nbytes = (w.numel() + x.numel()) * 4 + out_bytes
        nbytes += 0 if a is None else 8 * m
        ops_n = 2 * m * n * k_bits
        row = record(totals[name], name, label, err, run, twin, lib, nbytes, ops_n,
                     summed=summed, lib_bf16=lib_bf16)
        if name == "xnor_gemm" and not summed:
            totals[name]["served_head_ms"] = row["ms"]
        rows.append(row)
        del wf, xf, lib, lib_bf16
    for label, h, c, d in conv_cases():
        cw, k_bits = c // 32, 9 * c
        x = rand_words(gen, (BATCH, h, h, cw), dev)
        w = rand_words(gen, (d, 9 * cw), dev)
        a, b = rand_affine(gen, d, k_bits, dev)
        run = lambda: ops.fused_direct_conv(  # noqa: E731
            w, x, k_bits, a, b, kh=3, kw=3, stride=1, pad=1)
        twin = lambda: bitops.direct_conv_oracle(  # noqa: E731
            w, x, k_bits, a, b, kh=3, kw=3, stride=1, pad=1)
        want = twin()
        err = check_equal("fused_direct_conv", label, run(), want)
        # Yardstick: F.conv2d of the ±1 map, pre-padded with +1 (the
        # binary border), and the ±1 filters, NCHW, TF32 off; and the same
        # in bf16 (a timing yardstick only: its outputs round).
        xf = torch.nn.functional.pad(
            bitops.unpack_bits(x, axis=-1).permute(0, 3, 1, 2), (1, 1, 1, 1),
            value=1.0).contiguous()
        wf = bitops.unpack_bits(w, axis=-1).reshape(d, 3, 3, c).permute(
            0, 3, 1, 2).contiguous()
        lib = lambda: torch.nn.functional.conv2d(xf, wf)  # noqa: E731
        xh, wh = xf.bfloat16(), wf.bfloat16()
        lib_bf16 = lambda: torch.nn.functional.conv2d(xh, wh)  # noqa: E731
        nbytes = (x.numel() + w.numel() + BATCH * h * h * (d // 32)) * 4 + 8 * d
        ops_n = 2 * BATCH * h * h * d * k_bits
        rows.append(record(totals["fused_direct_conv"], "fused_direct_conv",
                           label, err, run, twin, lib, nbytes, ops_n,
                           lib_bf16=lib_bf16))
    return totals, rows


def record(total: dict, name: str, label: str, err, run, twin, lib,
           nbytes: int, ops_n: int, per_layer=None, summed: bool = True,
           plain_reps: int = 3, cold: bool = False,
           check: str = "exact", rate: float | None = None,
           lib_bf16=None) -> dict:
    """Time one main-path shape: kernel (graph replay and eager call),
    twin, library yardstick (``lib``; None where no single PyTorch call
    computes the function) and, for a megakernel, the slice-1 per-layer
    kernels over the same layers (``per_layer``). The kernel's totals sum the times of its
    main path's shapes only (``summed``); every shape's error counts.
    ``cold``: the kernel's time is taken with a cold L2 (its warm time is
    kept as ``warm_ms``). ``lib_bf16``: the library yardstick in bf16 (a
    timing yardstick only; its outputs round), kept as
    ``library_bf16_ms``. ``check`` says how the shape was held to its
    twin; ``rate`` replaces the kernel's peak rate in the bound (a
    float32 case of a bf16 kernel)."""
    ms = graph_ms(run, cold=cold)
    eager_ms = time_ms(run, iters=50)
    plain_ms = time_ms(twin, iters=2, reps=plain_reps)
    library_ms = graph_ms(lib, iters=5) if lib is not None else None
    bms, by = bound_ms(nbytes, ops_n,
                       rate or OPS_RATE.get(name, B1_OPS_PER_S))
    row = {"kernel": name, "shape": label, "max_abs_err": err, "ms": ms,
           "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "ops": ops_n}
    if cold:
        row["warm_ms"] = graph_ms(run)
    lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
    line = (f"  {name:21s} {label:18s} {check}  kernel {ms:.4f} ms"
            + (f" cold L2, {row['warm_ms']:.4f} warm" if cold else "")
            + f" (eager call {eager_ms:.4f})  plain {plain_ms:.3f} ms  library "
            f"{lib_txt}  bound {bms:.5f} ms ({by})")
    if per_layer is not None:
        row["per_layer_ms"] = graph_ms(per_layer)
        line += f"  per-layer kernels {row['per_layer_ms']:.4f} ms"
    if lib_bf16 is not None:
        row["library_bf16_ms"] = graph_ms(lib_bf16, iters=5)
        line += f"  library bf16 {row['library_bf16_ms']:.4f} ms"
    print(line, flush=True)
    total["max_abs_err"] = max(total["max_abs_err"], err)
    if not summed:
        return row
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "per_layer_ms",
              "library_bf16_ms"):
        if k in row:
            total[k] = None if row[k] is None else total.get(k, 0.0) + row[k]
    total["bytes"] += nbytes
    total["ops"] += ops_n
    return row


# (label, input H, channels of each conv) of the three conv stages.
STAGE_CASES = [("stage1/conv1", 32, (128, 128)),
               ("stage2/conv2+3", 16, (128, 256, 256)),
               ("stage3/conv4+5", 8, (256, 512, 512))]


def stage_operands(gen, h, chans, n, dev):
    x = rand_words(gen, (n, h, h, chans[0] // 32), dev)
    ws, aff, k_bits = [], [], []
    for cin, cout in zip(chans[:-1], chans[1:]):
        ws.append(rand_words(gen, (cout, 9 * cin // 32), dev))
        aff.append(rand_affine(gen, cout, 9 * cin, dev))
        k_bits.append(9 * cin)
    return x, ws, [p[0] for p in aff], [p[1] for p in aff], k_bits


def megakernel_phase(dev, totals: dict, rows: list) -> None:
    """Both megakernels at the main path's shapes, bit-exact against their
    twins, timed beside the per-layer kernels and a library chain (fp32,
    and bf16 for the conv stages)."""
    from repro_torch.core import bitops
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(1)
    F = torch.nn.functional
    for label, h, chans in STAGE_CASES:
        for n in (3, BATCH):
            x, ws, a, b, k_bits = stage_operands(gen, h, chans, n, dev)
            run = lambda: ops.megakernel_conv_stage(x, ws, a, b, k_bits)  # noqa: E731,B023
            twin = lambda: bitops.conv_stage_xla(x, ws, a, b, k_bits)  # noqa: E731,B023
            want = twin()
            err = check_equal("megakernel_conv_stage", f"{label} b{n}", run(),
                              want)
            if n != BATCH:
                print(f"  megakernel_conv_stage {label} batch {n}: exact",
                      flush=True)
                continue

            def per_layer(x=x, ws=ws, a=a, b=b, k_bits=k_bits):
                y = x
                for wl, al, bl, k in zip(ws, a, b, k_bits):
                    y = ops.fused_direct_conv(wl, y, k, al, bl, kh=3, kw=3,
                                              stride=1, pad=1)
                return bitops.maxpool2_packed(y)

            # Yardstick: F.conv2d of the ±1 map and filters (zero padding),
            # sign between convs, max_pool2d, NCHW, TF32 off.
            xf = bitops.unpack_bits(x, axis=-1).permute(0, 3, 1, 2).contiguous()
            wfs = [bitops.unpack_bits(wl, axis=-1).reshape(
                wl.shape[0], 3, 3, -1).permute(0, 3, 1, 2).contiguous()
                for wl in ws]

            def lib(xf=xf, wfs=wfs):
                y = xf
                for i, wf in enumerate(wfs):
                    y = F.conv2d(y if i == 0 else y.sign(), wf, padding=1)
                return F.max_pool2d(y, 2)

            xh, whs = xf.bfloat16(), [wf.bfloat16() for wf in wfs]

            out_words = n * (h // 2) ** 2 * chans[-1] // 32
            nbytes = (x.numel() + sum(wl.numel() for wl in ws) + out_words) * 4
            nbytes += 8 * sum(chans[1:])
            ops_n = 2 * n * h * h * sum(d * k for d, k in zip(chans[1:], k_bits))
            row = record(totals["megakernel_conv_stage"], "megakernel_conv_stage",
                         label, err, run, twin, lib, nbytes, ops_n,
                         per_layer=per_layer,
                         lib_bf16=lambda xh=xh, whs=whs: lib(xh, whs))
            # the launcher's occupancy query: shared memory of a CTA and the
            # clusters the card holds at once (the batch's 32 in one wave?)
            d_words = tuple(wl.shape[0] // 32 for wl in ws)
            row["smem_bytes"], row["clusters_at_once"] = next(
                (v for k, v in ops._LIMITS.items()
                 if k[0] == "megakernel_conv_stage" and k[2][0] == d_words),
                ("not measured", "not measured"))
            print(f"    {row['smem_bytes']} B of shared memory a CTA, "
                  f"{row['clusters_at_once']} clusters of {ops.MAX_CLUSTER} at once",
                  flush=True)
            rows.append(row)

    # The FC trunk: fc0 [1024, 8192] + fc1 [1024, 1024] stacked, head
    # [10, 1024]. Batch 32 as served (masked-tail path), then tails.
    w_stack = rand_words(gen, (2, 1024, 256), dev)
    w_stack[1, :, 32:] = 0                   # fc1's K pad words
    aff = [rand_affine(gen, 1024, k, dev) for k in (8192, 1024)]
    a_stack = torch.stack([p[0] for p in aff])
    b_stack = torch.stack([p[1] for p in aff])
    fin = rand_words(gen, (10, 32), dev)
    k_bits = (8192, 1024)
    w0, w1 = w_stack[0].contiguous(), w_stack[1, :, :32].contiguous()
    fc_words = (w0.numel() + w1.numel() + fin.numel()) * 4 + a_stack.numel() * 8
    for n, n_real in ((BATCH, BATCH), (8, 1), (8, 3), (16, 13)):
        x = rand_words(gen, (256, n), dev)
        run = lambda: ops.megakernel_chain(  # noqa: E731
            w_stack, a_stack, b_stack, k_bits, x, 1024, final_wp=fin,  # noqa: B023
            final_k_bits=1024, ragged_tile=ops.RAGGED_TILE_N, n_real=n_real)  # noqa: B023
        twin = lambda: bitops.megakernel_chain_ragged_xla(  # noqa: E731
            w_stack, a_stack, b_stack, k_bits, x, 1024, n_real,  # noqa: B023
            final_wp=fin, final_k_bits=1024)
        label = f"fc trunk b{n}" + (f" n_real {n_real}" if n_real != n else "")
        got = run()
        want = twin()
        err = check_equal("megakernel_chain", label, got, want)
        if got[:, n_real:].any():
            fail(f"megakernel_chain {label}: pad columns not zeroed")

        def per_layer(x=x):
            y = ops.fused_xnor_gemm(w0, x, 8192, a_stack[0], b_stack[0])
            # (no-op on the card, whose kernel outputs are contiguous)
            y = ops.fused_xnor_gemm(w1, y.contiguous(), 1024, a_stack[1],
                                    b_stack[1])
            return ops.xnor_gemm(fin, y.contiguous(), 1024)

        wf = [bitops.unpack_bits(w, axis=-1) for w in (w0, w1, fin)]
        xf = bitops.unpack_bits(x, axis=0)

        def lib(wf=wf, xf=xf):
            y = torch.matmul(wf[0], xf).sign()
            return torch.matmul(wf[2], torch.matmul(wf[1], y).sign())

        nbytes = fc_words + (x.numel() + 10 * n) * 4
        ops_n = 2 * n * (1024 * 8192 + 1024 * 1024 + 10 * 1024)
        row = record(totals["megakernel_chain"], "megakernel_chain", label,
                     err, run, twin, lib, nbytes, ops_n, per_layer=per_layer,
                     summed=n == n_real == BATCH)
        # the launch's cluster (gcd(16, M_max/32) where the card holds one)
        # and the occupancy query's shared memory a CTA
        geometry = ((256, 32), 2, 1024, 256, 10, 32)
        row["cluster"] = ops._chain_cluster(x.device, *geometry)
        row["smem_bytes"] = ops._LIMITS[("megakernel_chain", x.device.index,
                                         (*geometry, row["cluster"]))][0]
        print(f"    clusters of {row['cluster']} CTAs, {row['smem_bytes']} B of "
              "shared memory a CTA", flush=True)
        rows.append(row)


# (label, batch, chunk, d_inner, d_state, sequence the chunk is a view
# of) of the scan: the served prefill's second chunk of a 512-token
# prompt, a short prompt's only chunk, and a ragged case.
SCAN_CASES = [("prefill chunk", 4, 256, 16384, 16, 512),
              ("short prompt", 4, 32, 16384, 16, 32),
              ("ragged", 3, 37, 16384 + 96, 16, 37)]
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# jamba's dt rank, ceil(d_model / 16): B and C sit after it in x_proj's output.
JAMBA_DT_RANK = 512


def scan_error(name: str, label: str, got, want) -> float:
    """Max abs error of (y, h_last) against the twin's; fails outside
    ``SCAN_TOL`` (y sums over the state in another order)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name} {label}: {tuple(g.shape)} vs twin {tuple(w.shape)}, "
                 f"finite={bool(torch.isfinite(g).all())}")
        diff = (g - w).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        bad = int((diff > SCAN_TOL["atol"] + SCAN_TOL["rtol"] * w.abs()).sum())
        if bad:
            fail(f"{name} {label}: {bad} outputs outside rtol/atol 1e-5 of the "
                 f"plain twin (max abs err {err:.3g})")
    return err


def scan_operands(gen, b, c, di, ds, seq, dev):
    """The scan's operands as the mamba prefill hands them over: dt and x
    chunk views of ``[b, seq, di]`` tensors (the last chunk), B and C
    column slices of an x_proj output ``[b, seq, r + 2*ds]``, A of the
    model's init (-1..-ds), h0 != 0 (a carried state)."""
    sl = slice(seq - c, seq)
    dt = torch.nn.functional.softplus(
        torch.randn((b, seq, di), generator=gen, device=dev))[:, sl]
    xh = torch.randn((b, seq, di), generator=gen, device=dev)[:, sl]
    bc = torch.randn((b, seq, JAMBA_DT_RANK + 2 * ds), generator=gen,
                     device=dev)[:, sl]
    bm, cm = bc[..., JAMBA_DT_RANK:JAMBA_DT_RANK + ds], bc[..., JAMBA_DT_RANK + ds:]
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        di, ds).contiguous()
    h0 = torch.randn((b, di, ds), generator=gen, device=dev) * 0.1
    return dt, xh, bm, cm, a, h0


def scan_phase(dev, totals: dict, rows: list) -> None:
    """``ssm_scan_chunk`` at the served prefill's chunk (its time makes the
    kernels-line total), a short prompt's chunk and a ragged case, held
    within rtol/atol 1e-5 of its twin on the card. Bound: the
    larger of the bytes over HBM and the exps over the MUFU rate; the FP32
    issue bound (6 operations per exp plus dt*x) is kept beside it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssm_scan_chunk_ref
    from repro_torch.roofline import op_cost

    gen = torch.Generator(device=dev).manual_seed(14)
    for label, b, c, di, ds, seq in SCAN_CASES:
        args = scan_operands(gen, b, c, di, ds, seq, dev)
        run = lambda: ops.ssm_scan_chunk(*args)  # noqa: E731,B023
        twin = lambda: ssm_scan_chunk_ref(*args)  # noqa: E731,B023
        want = twin()
        err = scan_error("ssm_scan_chunk", label, run(), want)
        exps = op_cost.scan_flops(b, c, di, ds)
        nbytes = (3 * b * c * di + 2 * b * di * ds + di * ds + 2 * b * c * ds) * 4
        row = record(totals["ssm_scan_chunk"], "ssm_scan_chunk",
                     f"{label} [{b},{c},{di},{ds}]", err, run, twin, None,
                     nbytes, exps, summed=label == "prefill chunk",
                     check=f"max err {err:.2g}")
        row["fp32_bound_ms"] = (6 * exps + b * c * di) / FP32_OPS_PER_S * 1e3
        if label == "prefill chunk":
            totals["ssm_scan_chunk"]["fp32_bound_ms"] = row["fp32_bound_ms"]
        rows.append(row)


# (label, BH, S, Dh, dtype) of flash attention: smollm-360m's training
# forward (batch 4 x 15 heads, S 4096; its time makes the kernels-line
# total), the same in float32, a ragged case (odd BH, S not a multiple of
# the bf16 kernel's 128-row block), and pixtral-12b's training forward
# (batch 2 x 32 heads, the 8 KV heads repeated, Dh 128; phase 12).
FLASH_CASES = [("smollm layer", 60, 4096, 64, torch.bfloat16),
               ("float32", 60, 4096, 64, torch.float32),
               ("ragged", 3, 1000, 64, torch.bfloat16),
               ("pixtral layer", 64, 4096, 128, torch.bfloat16)]
# Float32: rtol/atol 1e-5 (dot products and sums in other orders). Bf16:
# one bf16 ulp of the largest output of the row, each output within
# FLASH_ELEM_ULPS bf16 ulps of its own and at most FLASH_PAST_SHARE of
# the outputs past one (see flash_error). The last two are set from the
# readings on an H100 (at most 13 own ulps, at most 6.1e-5 of a call's
# outputs past one, on random inputs and on smollm-360m's own), with
# room: a kernel that moved small outputs within their row's ulp would
# move far more than 0.1% of them.
FLASH_F32_TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_ELEM_ULPS = 32.0
FLASH_PAST_SHARE = 1e-3
# (label, BH, S, dk, dv, chunk) of the mLSTM: xlstm-1.3b's training
# forward (batch 2 x 4 heads, 16 chunks of 256; its time makes the
# total) and a one-chunk sequence.
MLSTM_CASES = [("xlstm layer", 8, 4096, 1024, 1024, 256),
               ("one chunk", 8, 256, 1024, 1024, 256)]
# The flash backward's cases: the forward's, and a head width of 128 (the
# dK/dV kernel's query tile halves there so its accumulators fit).
FLASH_BWD_CASES = FLASH_CASES[:3] + [("dh 128", 16, 4096, 128, torch.bfloat16)]
# y, C, n: float32 sums over dk and the chunk in other orders. m: the same
# float operations in the same order as the twin, so equal.
MLSTM_TOL = dict(rtol=1e-4, atol=1e-4)


def bf16_ulp(x: torch.Tensor, floor: float = 2.0**-8) -> torch.Tensor:
    """One bfloat16 ulp at the magnitude of ``x`` (float32), taken at
    ``floor`` below it."""
    _, exp = torch.frexp(torch.clamp(x.abs(), min=floor))
    return torch.ldexp(torch.ones_like(x), exp - 8)


def flash_error(label: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Flash attention against its twin with the kernel's KV tile (which
    rounds where the kernel rounds). Float32: within ``FLASH_F32_TOL``.
    Bf16: within one bf16 ulp of the largest output of each row: the
    tensor cores sum q . k in another order than cuBLAS, and where a
    score moves by a float32 ulp p's rounding to bf16 can flip, which
    moves the row by up to 2^-8 p_j |v_j| / l, a step at the scale of the
    row's values. Each output is also held within ``FLASH_ELEM_ULPS``
    bf16 ulps of its own (taken at 2^-8 below it, as ``bf16_ulp`` does),
    and at most ``FLASH_PAST_SHARE`` of the outputs may be past one."""
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.isfinite(got).all():
        fail(f"flash_attention {label}: {tuple(got.shape)}/{got.dtype} vs twin "
             f"{tuple(want.shape)}/{want.dtype}, finite="
             f"{bool(torch.isfinite(got).all())}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    out = {"max_abs_err": float(diff.max())}
    if got.dtype == torch.float32:
        bad = int((diff > FLASH_F32_TOL["atol"] + FLASH_F32_TOL["rtol"] * w.abs()).sum())
        what = "rtol/atol 1e-5"
    else:
        row_ulps = diff / bf16_ulp(w.abs().amax(-1, keepdim=True))
        elem_ulps = diff / bf16_ulp(w)
        past = int((elem_ulps > 1).sum())
        out.update(max_row_ulps=float(row_ulps.max()),
                   max_elem_ulps=float(elem_ulps.max()),
                   elements_past_own_ulp=past, elements=diff.numel())
        bad = int((row_ulps > 1).sum()) + int((elem_ulps > FLASH_ELEM_ULPS).sum())
        what = (f"one bf16 ulp of their row's largest output or "
                f"{FLASH_ELEM_ULPS:g} of their own (max {out['max_elem_ulps']:.3g})")
        if past > FLASH_PAST_SHARE * diff.numel():
            fail(f"flash_attention {label}: {past} of {diff.numel()} outputs past "
                 f"one bf16 ulp of their own, more than {FLASH_PAST_SHARE:g}")
    if bad:
        fail(f"flash_attention {label}: {bad} outputs outside {what} of the "
             f"plain twin (max abs err {out['max_abs_err']:.3g})")
    return out


def mlstm_error(label: str, got, want) -> dict:
    """Max abs error of each of (y, C, n) against the twin's, and its
    largest share of the limit, within ``MLSTM_TOL``; m equal."""
    err = {}
    for name, g, w in zip(("y", "C", "n"), got[:3], want[:3]):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"mlstm_chunked {label}: {name} {tuple(g.shape)} vs twin "
                 f"{tuple(w.shape)}, finite={bool(torch.isfinite(g).all())}")
        diff = (g - w).abs()
        limit = MLSTM_TOL["atol"] + MLSTM_TOL["rtol"] * w.abs()
        err[name] = float(diff.max())
        err[f"{name}_of_limit"] = float((diff / limit).max())
        bad = int((diff > limit).sum())
        if bad:
            fail(f"mlstm_chunked {label}: {bad} of {name} outside rtol/atol 1e-4 "
                 f"of the plain twin (max abs err {float(diff.max()):.3g})")
    if not torch.equal(got[3], want[3]):
        fail(f"mlstm_chunked {label}: m differs from the twin's (max abs "
             f"{float((got[3] - want[3]).abs().max()):.3g})")
    err["max_abs_err"] = max(err["y"], err["C"], err["n"])
    err["max_of_limit"] = max(err["y_of_limit"], err["C_of_limit"], err["n_of_limit"])
    return err


def flash_twin(q, k, v, causal=True):
    """The flash twin with the kernel's KV tile."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    return flash_attention_ref(q, k, v, causal=causal, block_kv=ops.FLASH_TILE)


def attention_phase(dev, totals: dict, rows: list) -> None:
    """``flash_attention`` at smollm-360m's training shape (bf16; its time
    makes the kernels-line total), in float32, at a ragged shape and at
    pixtral-12b's training shape (Dh 128), and
    ``mlstm_chunked`` at xlstm-1.3b's (its time makes the total) and on a
    one-chunk sequence, each held to its twin on the card and timed.
    Library yardstick of flash: ``F.scaled_dot_product_attention(...,
    is_causal=True)`` on the same tensors; none for the mLSTM. Bounds:
    flash 2 BH S^2 Dh operations (causal) at the bf16 tensor-core rate
    (float32 case: the CUDA cores' float32 rate) against Q, K, V and O;
    the mLSTM L (L + 1) (dk + dv) + 4 L dk dv per (bh, chunk) (the
    causal half of q k^T and of the weights times v, the diagonal
    included, then q C and the update of C) at the float32 rate against
    its operands."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlstm_chunked_ref
    from repro_torch.roofline import op_cost

    gen = torch.Generator(device=dev).manual_seed(15)
    F = torch.nn.functional
    for label, bh, s, dh, dtype in FLASH_CASES:
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        run = lambda: ops.flash_attention(q, k, v)  # noqa: E731,B023
        twin = lambda: flash_twin(q, k, v)  # noqa: E731,B023
        q4, k4, v4 = q[None], k[None], v[None]     # [1, BH, S, Dh]: SDPA's layout
        lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731,B023
        e = flash_error(label, run(), twin())
        nbytes = 4 * bh * s * dh * q.element_size()
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        check = f"max err {e['max_abs_err']:.2g}" + (
            f", {e['max_row_ulps']:.2f} row ulps, {e['max_elem_ulps']:.2f} own "
            f"ulps, {e['elements_past_own_ulp']} of {e['elements']} past their "
            f"own ulp" if "max_row_ulps" in e else "")
        row = record(totals["flash_attention"], "flash_attention",
                     f"{label} [{bh},{s},{dh}] {str(dtype)[6:]}", e["max_abs_err"],
                     run, twin, lib, nbytes, op_cost.flash_flops(bh, s, s, dh),
                     summed=label == "smollm layer", check=check, rate=rate)
        row.update(e)
        rows.append(row)
    for label, bh, s, dk, dv, chunk in MLSTM_CASES:
        q = torch.randn((bh, s, dk), generator=gen, device=dev) * dk ** -0.5
        k = torch.randn((bh, s, dk), generator=gen, device=dev)
        v = torch.randn((bh, s, dv), generator=gen, device=dev)
        logi = torch.randn((bh, s), generator=gen, device=dev)
        logf = F.logsigmoid(torch.randn((bh, s), generator=gen, device=dev) + 2)
        args = (q, k, v, logi, logf)
        run = lambda: ops.mlstm_chunked(*args, chunk=chunk)  # noqa: E731,B023
        twin = lambda: mlstm_chunked_ref(*args, chunk=chunk)  # noqa: E731,B023
        err = mlstm_error(label, run(), twin())
        ln = min(chunk, s)
        ops_n = op_cost.mlstm_flops(bh, s, dk, dv, chunk)
        nbytes = 4 * (bh * s * (2 * dk + 2 * dv + 2) + bh * (dk * dv + dk + 1))
        row = record(totals["mlstm_chunked"], "mlstm_chunked",
                     f"{label} [{bh},{s},{dk},{dv}] L{ln}", err["max_abs_err"],
                     run, twin, None, nbytes, ops_n, summed=label == "xlstm layer",
                     check=(f"max err y {err['y']:.2g} C {err['C']:.2g} n "
                            f"{err['n']:.2g} ({err['max_of_limit']:.2f} of the "
                            "limit), m equal"))
        row.update(err)
        # the same products as 3xTF32 passes on the tensor cores, the design
        # the kernel runs (its bound_ms keeps the float32 rate)
        row["tc_bound_ms"] = bound_ms(nbytes, 3 * ops_n, TF32_OPS_PER_S)[0]
        print(f"    3xTF32 bound {row['tc_bound_ms']:.5f} ms", flush=True)
        if label == "xlstm layer":
            totals["mlstm_chunked"]["tc_bound_ms"] = row["tc_bound_ms"]
            # the call's five kernels: the gates within chunks and their
            # chain, the intra-chunk weights, the chunk states, the outputs
            row["breakdown"] = device_breakdown(run, top=5)
            print("    its kernels: " + (row["breakdown"] if isinstance(
                row["breakdown"], str) else ", ".join(
                    f"{n.split('(')[0].split()[-1]} {ms:.3f} ms"
                    for n, ms, _ in row["breakdown"][:-1])), flush=True)
        rows.append(row)


def launches_per_forward(path: str) -> dict:
    """Kernel launches one forward of the BNN makes on ``path``:
    ``direct``/``im2col`` (the per-layer ``xnor`` engine) one per binary
    conv (direct conv, or the im2col GEMM), one fused GEMM per hidden
    FC, one xnor_gemm for the head; ``megakernel`` one launch per conv
    stage and one for the FC trunk. A Table 2 preset of ``bnn_apply``
    (``PAPER_KERNEL`` ...): ``pack_rows`` + ``xnor_gemm`` per binary
    layer, or ``direct_conv`` for the convs and ``pack_rows`` +
    ``xnor_gemm`` for the FCs, or one ``unpack_gemm`` per binary layer;
    none for the plain-torch and float presets."""
    from repro_torch.core.bnn import CONV_CHANNELS, CONV_STAGES, FC_SIZES
    from repro_torch.kernels import ops

    counts = dict.fromkeys(ops.LAUNCHES, 0)
    convs, fcs = len(CONV_CHANNELS) - 1, len(FC_SIZES)
    if path == "megakernel":
        counts.update(megakernel_conv_stage=len(CONV_STAGES),
                      megakernel_chain=1)
    elif path == "direct":
        counts.update(xnor_gemm=1, fused_xnor_gemm=fcs - 1,
                      fused_direct_conv=convs)
    elif path == "im2col":
        counts.update(xnor_gemm=1, fused_xnor_gemm=fcs - 1 + convs)
    elif path == "PAPER_KERNEL":
        counts.update(pack_rows=convs + fcs, xnor_gemm=convs + fcs)
    elif path == "DIRECT_KERNEL":
        counts.update(direct_conv=convs, pack_rows=fcs, xnor_gemm=fcs)
    elif path == "MXU_KERNEL":
        counts.update(unpack_gemm=convs + fcs)
    elif path not in ("XLA_PACKED", "CONTROL_GROUP", "SIMULATION"):
        raise ValueError(f"unknown path {path!r}")
    return counts


def serve_phase(dev) -> dict:
    from repro_torch.core.bnn import (bnn_apply_fused, bnn_apply_megakernel,
                                      first_conv_packed,
                                      load_binary_checkpoint,
                                      pack_bnn_params_fused,
                                      pack_bnn_params_megakernel)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_bnn import random_requests
    from repro_torch.serve import (ContinuousServingEngine, FallbackPolicy,
                                   ServingEngine, default_extents, is_error)

    latent = load_binary_checkpoint(CKPT, device=dev)
    packed = pack_bnn_params_fused(latent)
    mega = pack_bnn_params_megakernel(latent)
    rng = np.random.default_rng(0)
    requests = random_requests(rng, count=12, max_images=8)
    result = {"requests": len(requests),
              "images": sum(r.shape[0] for r in requests)}

    engines, launches = {}, {}
    for path in ("direct", "im2col", "megakernel"):
        # This path's counts: 0 just before its engine is built, read
        # just after its drain.
        ops.reset_launches()
        t0 = time.monotonic()
        # max_wait 0: every step dispatches what is queued, so the
        # ragged requests reach several buckets or extent classes.
        if path == "megakernel":
            eng = ContinuousServingEngine(
                mega, engine="megakernel", max_wait_s=0.0,
                fallback=FallbackPolicy(fused_params=packed, mega_params=mega))
            if eng.warmup() != len(default_extents(32)):
                fail(f"megakernel: {len(eng.extents)} extent classes warmed, "
                     f"expected {default_extents(32)}")
        else:
            eng = ServingEngine(packed, engine="xnor", conv_impl=path,
                                max_wait_s=0.0)
            eng.warmup()
        t1 = time.monotonic()
        rids = []
        for imgs in requests:
            rids.append(eng.submit(imgs))
            eng.step()
        eng.drain()
        torch.cuda.synchronize()
        t2 = time.monotonic()
        launches[path] = dict(ops.LAUNCHES)
        engines[path] = (eng, [eng.take(r) for r in rids])
        result[f"{path}_warmup_s"] = t1 - t0
        result[f"{path}_serve_s"] = t2 - t1
    result["launches"] = launches

    for path, (eng, got) in engines.items():
        snap = eng.snapshot()
        # Every warmed bucket or extent class ran one forward eagerly
        # before its capture and one replay at warmup, then every served
        # batch a replay (whose launches the executor counts).
        shapes = eng.extents if path == "megakernel" else eng.batcher.buckets
        forwards = 2 * len(shapes) + snap["batches"]["dispatched"]
        expected = {k: v * forwards
                    for k, v in launches_per_forward(path).items()}
        if launches[path] != expected:
            fail(f"{path}: kernel launches {launches[path]} over "
                 f"{forwards} forwards, expected {expected}")
        if snap["dispatch"]["fallbacks"] or snap["degraded"]:
            fail(f"{path}: engine failover recorded: "
                 f"{snap['dispatch']['engine_path']}")
        if snap["requests"]["completed"] != len(requests):
            fail(f"{path}: {snap['requests']['completed']} of "
                 f"{len(requests)} requests completed")
        for i, (imgs, logits) in enumerate(zip(requests, got)):
            if logits is None or is_error(logits):
                fail(f"{path}: request {i} has no logits: {logits}")
            with torch.inference_mode():
                want = bnn_apply_fused(
                    packed, torch.from_numpy(imgs).to(dev), engine="xla",
                    conv_impl="direct" if path == "megakernel"
                    else path).cpu().numpy()
            if logits.shape != (imgs.shape[0], 10) or not np.isfinite(logits).all():
                fail(f"{path}: request {i} logits {logits.shape}, finite="
                     f"{np.isfinite(logits).all()}")
            if not np.array_equal(logits, want):
                fail(f"{path}: request {i}: served logits differ "
                     f"from the xla forward (max abs "
                     f"{np.abs(logits - want).max()})")
        print(f"  serve {eng.executors.engine}/{path}: {len(requests)} "
              f"requests ({result['images']} images) bit-identical to xla; "
              f"warmup {result[f'{path}_warmup_s']:.3f} s, serve "
              f"{result[f'{path}_serve_s']:.3f} s, batch shapes "
              f"{snap['batches']['per_bucket']}", flush=True)
        print(f"  launches on the {path} path ({forwards} forwards): "
              f"{launches[path]}", flush=True)
    # Reference on a small input: the card's forward against the CPU's
    # plain-torch forward of the same 4 images.
    imgs = torch.from_numpy(requests[0][:4].copy())
    packed_cpu = pack_bnn_params_fused(load_binary_checkpoint(CKPT, device="cpu"))
    with torch.inference_mode():
        cpu = bnn_apply_fused(packed_cpu, imgs, engine="xla", conv_impl="direct")
        gpu = bnn_apply_fused(packed, imgs.to(dev), engine="xnor",
                              conv_impl="direct").cpu()
        flips = int((first_conv_packed(packed_cpu, imgs)
                     != first_conv_packed(packed, imgs.to(dev)).cpu()).sum())
    diff = float((cpu - gpu).abs().max())
    result.update(cpu_vs_gpu_max_abs=diff, cpu_vs_gpu_first_conv_words=flips)
    print(f"  card vs CPU on {imgs.shape[0]} images: max |logit diff| {diff}, "
          f"first-conv words differing {flips}", flush=True)
    if not torch.allclose(cpu, gpu, rtol=1e-5, atol=1e-4) or not torch.equal(
            cpu.argmax(1), gpu.argmax(1)):
        fail("card logits disagree with the CPU plain-torch forward")

    # Whole forward at batch 32, by CUDA events: as called (eager) and
    # replayed from a CUDA graph (device time only, no host gaps).
    x32 = torch.from_numpy(rng.normal(size=(BATCH, 32, 32, 3)).astype(
        np.float32)).to(dev)
    with torch.inference_mode():
        for engine, conv_impl in (("xnor", "direct"), ("xnor", "im2col"),
                                  ("megakernel", "stages"), ("xla", "direct")):
            if engine == "megakernel":
                fwd = lambda: bnn_apply_megakernel(  # noqa: E731
                    mega, x32, engine="xnor", ragged=True)
            else:
                fwd = lambda: bnn_apply_fused(  # noqa: E731
                    packed, x32, engine=engine, conv_impl=conv_impl)  # noqa: B023
            ms = time_ms(fwd, iters=1 if engine == "xla" else 10, reps=3)
            result[f"forward_b32_{engine}_{conv_impl}_ms"] = ms
            line = f"  forward batch {BATCH} {engine}/{conv_impl}: {ms:.3f} ms"
            if engine != "xla":
                gms = graph_ms(fwd, iters=5)
                result[f"forward_b32_{engine}_{conv_impl}_graph_ms"] = gms
                # The share of the eager forward the device waits on the host.
                result[f"forward_b32_{engine}_{conv_impl}_idle"] = 1 - gms / ms
                line += (f" eager, {gms:.3f} ms replayed from a CUDA graph "
                         f"(device idle {1 - gms / ms:.2f} of the eager call)")
            print(line, flush=True)
        fc = lambda: first_conv_packed(packed, x32)  # noqa: E731
        result["first_conv_b32_ms"] = time_ms(fc, iters=10, reps=3)
        result["first_conv_b32_graph_ms"] = graph_ms(fc, iters=5)
        print(f"  first conv + BN + pack, batch {BATCH}: "
              f"{result['first_conv_b32_ms']:.3f} ms eager, "
              f"{result['first_conv_b32_graph_ms']:.3f} ms graph", flush=True)
    return result


# The bucket ladder and extent classes phase 4 captures, and the engines.
GRAPH_BUCKETS = (1, 8, 32, 128)
GRAPH_PATHS = [("xnor", "direct"), ("xnor", "im2col"), ("xla", "direct"),
               ("xla", "im2col"), ("megakernel", "direct"),
               ("megakernel_xla", "direct")]
# The continuous engine's extent classes at 32 rows (1/2/4/8/16/24/32), for
# the megakernel engines and the per-layer rungs of its fallback ladder.
RAGGED_PATHS = [("megakernel", "im2col"), ("megakernel_xla", "im2col"),
                ("xnor", "im2col"), ("xla", "im2col")]


def graph_phase(dev, packed: dict, mega: dict) -> dict:
    """Phase 4(a): every executor a deployment can capture, its
    graph-replayed logits against the eager forward's, bit for bit: each
    engine x conv_impl x bucket of the default ladder, and each extent
    class of the continuous engine for every rung of its ladder. Each
    cache is warmed first; its captures must equal the shapes warmed, and
    the checks after it (hits only) must add none."""
    from repro_torch.core.bnn import bnn_serve_fn
    from repro_torch.serve import (ExecutorCache, RaggedExecutorCache,
                                   default_extents)

    rng = np.random.default_rng(40)
    result = {}
    cases = [(ExecutorCache, GRAPH_BUCKETS, p, False) for p in GRAPH_PATHS]
    cases += [(RaggedExecutorCache, default_extents(32), p, True)
              for p in RAGGED_PATHS]
    for cls, shapes, (engine, conv_impl), ragged in cases:
        params = mega if engine.startswith("megakernel") else packed
        t0 = time.monotonic()
        cache = cls(params, engine=engine, conv_impl=conv_impl)
        warmed = cache.warmup(shapes)
        t_warm = time.monotonic() - t0
        eager = bnn_serve_fn(engine=engine, conv_impl=conv_impl, ragged=ragged)
        for rows in shapes:
            x = rng.normal(size=(rows, 32, 32, 3)).astype(np.float32)
            got = cache.run(x)
            want = eager(params, torch.from_numpy(x).to(dev)).cpu().numpy()
            if got.shape != (rows, 10) or not np.array_equal(got, want):
                fail(f"graph {engine}/{conv_impl} {cls.__name__} at {rows}: "
                     "replayed logits differ from the eager forward (max abs "
                     f"{np.abs(got - want).max() if got.shape == want.shape else 'shape'})")
        compiles = cache.stats.executor_compiles
        if not warmed == compiles == len(shapes) or cache.size != len(shapes):
            fail(f"graph {engine}/{conv_impl} {cls.__name__}: {compiles} "
                 f"captures ({warmed} at warmup) for {len(shapes)} shapes")
        name = f"{engine}/{conv_impl}/{'extents' if ragged else 'buckets'}"
        result[name] = {"shapes": list(shapes), "captures": compiles,
                        "warmup_s": t_warm}
        print(f"  graphs {name}: {len(shapes)} shapes {list(shapes)} "
              f"replayed bit-identical to eager; {compiles} captures, "
              f"{warmed} at warmup ({t_warm:.2f} s)", flush=True)
        cache.release()
    return result


def first_conv_invariance(dev, packed: dict) -> dict:
    """Phase 4a, first: the float first conv's packed words of 256 images
    must not depend on the batch they come in (batches of 1, 3, 8, 24, 32
    and 128; ``core.bnn._first_conv`` runs its GEMM on fixed chunks), with
    the trained checkpoint's weights and with the serving CLI's random
    ones (seed 0). Beside it, for the record, the words that one GEMM of
    the whole batch, as ``bit_conv2d`` computes it, flips against one image
    at a time."""
    from repro_torch.core import bitops
    from repro_torch.core.binarize import QuantMode
    from repro_torch.core.bnn import (_batchnorm, first_conv_packed,
                                      init_bnn_params, pack_bnn_params_fused)
    from repro_torch.core.layers import BitLinearConfig, bit_conv2d

    imgs = torch.from_numpy(np.random.default_rng(42).normal(
        size=(256, 32, 32, 3)).astype(np.float32)).to(dev)
    lcfg = BitLinearConfig(mode=QuantMode.FAKE_QUANT, binarize_acts=False)
    result = {}
    for name, params in (("trained", packed), ("random seed 0",
                         pack_bnn_params_fused(init_bnn_params(0, device=dev)))):

        def one_gemm(x, params=params):
            y = bit_conv2d(params["conv"][0], x, lcfg, stride=1, pad=1)
            return bitops.pack_bits(_batchnorm(params["bn_conv0"], y), axis=-1)

        def words(fn, n):
            with torch.inference_mode():
                return torch.cat([fn(imgs[i:i + n]) for i in range(0, 256, n)])

        served = lambda x, params=params: first_conv_packed(params, x)  # noqa: E731
        ref = words(served, 1)
        for n in (3, 8, 24, 32, 128):
            if not torch.equal(words(served, n), ref):
                fail(f"first conv ({name} weights): the packed words of a batch "
                     f"of {n} differ from one image at a time")
        alone = words(one_gemm, 1)
        flips = {n: int((words(one_gemm, n) != alone).sum()) for n in (8, 32, 128)}
        result[name] = {"one_gemm_word_flips": flips}
        print(f"  first conv, {name} weights: 256 images' words equal at batches "
              f"1/3/8/24/32/128; one GEMM of the whole batch would flip {flips} "
              f"of {alone.numel()} words against one image at a time", flush=True)
    return result


# Phase 4(b): each tunable kernel's shapes, Table 2's (batch 64) and the
# batch-32 served ones, and the one shape ``tune`` runs at.
def tiling_shapes(paper_batch: int) -> dict:
    from repro_torch.kernels import autotune

    gemm = autotune.gemm_shape
    paper = [gemm(m, kw, n) for _, m, kw, n, _ in paper_gemm_cases(paper_batch)]
    head, fused = gemm_cases()
    served = [gemm(m, kw, n) for _, m, kw, n, _ in head + fused]
    convs = {b: [autotune.conv_shape(b, h, h, c // 32, d, 3, 3, 1, 1)
                 for _, h, c, d in conv_cases()] for b in (paper_batch, BATCH)}
    stages = [autotune.stage_shape(BATCH, h, h, chans[0] // 32,
                                   [c // 32 for c in chans[1:]], 3, 3, 1, True)
              for _, h, chans in STAGE_CASES]
    trunk = autotune.chain_shape((256, 32), 1024, 256, 256, 10, 32, BATCH)
    return {
        "xnor_gemm": (paper + served[:1], served[0]),
        "fused_xnor_gemm": (served[1:], served[1]),
        "fused_direct_conv": (convs[BATCH], convs[BATCH][0]),
        "direct_conv": (convs[paper_batch] + convs[BATCH], convs[BATCH][0]),
        "megakernel_conv_stage": (stages, stages[0]),
        "megakernel_chain": ([trunk], trunk),
    }


TILING_TWINS = {"xnor_gemm": "xnor_popcount_matmul",
                "fused_xnor_gemm": "fused_xnor_layer",
                "fused_direct_conv": "direct_conv_oracle",
                "direct_conv": "direct_conv_dot",
                "megakernel_conv_stage": "conv_stage_xla",
                "megakernel_chain": "megakernel_chain_xla"}


def tiling_phase(dev, paper_batch: int, packed: dict, mega: dict) -> dict:
    """Phase 4(b): every tiling ``kernels.autotune`` can select, at each
    tunable kernel's Table 2 and served shapes, bit-identical to the
    twin (a cluster whose shared memory exceeds a block's must raise
    ValueError, and is counted); then ``tune`` once per kernel at its
    batch-32 served shape and ``tune_serving_blocks`` at bucket 32, each
    winner printed beside the ``AUTO`` time. The cache is a fresh file
    under ``build/``, removed after, so no later phase reads a tuned
    entry: their ``AUTO`` is the heuristic."""
    import os

    from repro_torch.core import bitops
    from repro_torch.kernels import autotune
    from repro_torch.serve import tune_serving_blocks

    cache = OUT_DIR / "chip_smoke_autotune.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
    os.environ.pop("REPRO_AUTOTUNE", None)
    result = {"variants": {}, "tuned": {}, "serving": {}}
    try:
        for kernel, (shapes, tune_at) in tiling_shapes(paper_batch).items():
            twin = getattr(bitops, TILING_TWINS[kernel])
            ran = refused = 0
            for shape in shapes:
                call = autotune.operands(kernel, shape, dev)
                want = twin(*call.args, **call.kwargs)
                for cfg in autotune.default_candidates(kernel, shape):
                    try:
                        got = call(**autotune.block_kwargs(cfg, kernel))
                    except ValueError:
                        refused += 1
                        continue
                    torch.cuda.synchronize()
                    check_equal(kernel, f"{shape} {cfg.key()}", got, want)
                    ran += 1
            timings = {}
            best = autotune.tune(kernel, tune_at, device=dev, timings=timings)
            entry = autotune.load_entry(kernel, tune_at)
            if entry != best:
                fail(f"tune {kernel}: the cache holds {entry}, not {best}")
            result["variants"][kernel] = {"shapes": len(shapes), "ran": ran,
                                          "refused": refused}
            result["tuned"][kernel] = {
                "shape": tune_at, "winner": best.key(),
                "winner_ms": timings[best] * 1e3,
                "auto_ms": timings[autotune.AUTO] * 1e3,
                "candidates_ms": {(c if isinstance(c, str) else c.key()):
                                  (None if t is None else t * 1e3)
                                  for c, t in timings.items()}}
            print(f"  tilings {kernel}: {ran} variants at {len(shapes)} shapes "
                  f"bit-identical to the twin ({refused} refused: shared "
                  f"memory); tuned at {tune_at}: {best.key()} "
                  f"{timings[best] * 1e3:.4f} ms vs AUTO "
                  f"{timings[autotune.AUTO] * 1e3:.4f} ms", flush=True)
        for engine, conv_impl, params in (("xnor", "direct", packed),
                                          ("xnor", "im2col", packed),
                                          ("megakernel", "direct", mega)):
            timings = {}
            best = tune_serving_blocks(params, BATCH, engine=engine,
                                       conv_impl=conv_impl, timings=timings)
            key = f"{engine}/{conv_impl}"
            result["serving"][key] = {
                "winner": autotune.blocks_key(best),
                "candidates_ms": {autotune.blocks_key(c):
                                  (None if t is None else t * 1e3)
                                  for c, t in timings.items()}}
            print(f"  serving tiling {key} at bucket {BATCH}: "
                  f"{autotune.blocks_key(best)} {timings[best] * 1e3:.4f} ms vs "
                  f"AUTO {timings[autotune.AUTO] * 1e3:.4f} ms (graph replay)",
                  flush=True)
    finally:
        cache.unlink(missing_ok=True)
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    return result


# Phase 4(c): arrivals a second and seconds of the load runs.
LOAD_RATE, LOAD_SECONDS = 500.0, 3.0


def load_phase() -> dict:
    """Phase 4(c): ``run_sustained`` of the serving CLI on the card,
    ``LOAD_SECONDS`` of open-loop arrivals at ``LOAD_RATE`` requests a
    second (1-8 images each, random weights from seed 0), on the
    megakernel continuous engine (32 rows a dispatch) and the xnor/direct
    bucket engine (the default ladder); every answered request's logits
    held to its exact-shape forward. A failed, unanswered or divergent
    request fails the phase."""
    from repro_torch.launch import serve_bnn

    result = {}
    for name, argv in (
            ("megakernel/continuous", ["--scheduler", "continuous",
                                       "--engine", "megakernel"]),
            ("xnor/direct/bucket", ["--engine", "xnor", "--conv-impl",
                                    "direct"])):
        args = serve_bnn.parse_args(
            ["--sustained", "--rate", str(LOAD_RATE), "--duration",
             str(LOAD_SECONDS), "--device", "cuda"] + argv)
        try:
            snap = serve_bnn.run_sustained(args)
        except SystemExit as err:
            fail(f"load run {name}: {err}")
        lat = snap["latency_s"]
        result[name] = {
            "requests": snap["requests"]["completed"],
            "images_per_s": snap["throughput"]["images_per_s"],
            "p50_ms": lat["p50"] * 1e3, "p95_ms": lat["p95"] * 1e3,
            "p99_ms": lat["p99"] * 1e3,
            "pad_row_fraction": snap["batches"]["pad_row_fraction"],
            "dispatches": snap["batches"]["dispatched"],
            "captures": snap["executors"]["compiles"],
            "check": snap["check"]}
        r = result[name]
        print(f"  load {name}: {r['requests']} requests at {LOAD_RATE:.0f}/s "
              f"for {LOAD_SECONDS:.0f} s: p50 {r['p50_ms']:.3f} ms, p99 "
              f"{r['p99_ms']:.3f} ms, {r['images_per_s']:.1f} images/s, pad "
              f"fraction {r['pad_row_fraction']:.3f}, {r['dispatches']} "
              f"dispatches, {r['captures']} captures; every logit checked",
              flush=True)
    return result


def engine_latency(dev, packed: dict, mega: dict, reps: int = 50) -> dict:
    """Phase 4(d): one request of 32 images through the serving engine
    with graphs, submit to logits on the host clock (median of ``reps``
    after a warmed ladder): the bucket engine (xnor/direct, a bucket of
    32) and the continuous megakernel engine (32 rows a dispatch)."""
    from repro_torch.serve import ContinuousServingEngine, ServingEngine

    x = np.random.default_rng(41).normal(size=(BATCH, 32, 32, 3)).astype(
        np.float32)
    result = {}
    for name, eng in (
            ("xnor_direct", ServingEngine(packed, engine="xnor",
                                          conv_impl="direct", buckets=(BATCH,),
                                          max_wait_s=0.0)),
            ("megakernel", ContinuousServingEngine(mega, engine="megakernel",
                                                   max_rows=BATCH,
                                                   max_wait_s=0.0))):
        eng.warmup()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rid = eng.submit(x)
            eng.step()
            eng.drain()
            logits = eng.take(rid)
            times.append(time.perf_counter() - t0)
            if logits is None or logits.shape != (BATCH, 10):
                fail(f"engine latency {name}: no logits")
        result[f"engine_b32_{name}_ms"] = statistics.median(times) * 1e3
    return result


def unfused_kernel_phase(dev, totals: dict, rows: list, batch: int,
                         summed: bool) -> None:
    """The unfused PACKED kernels at the eight binary layers of the Table
    2 forward at ``batch``: ``pack_rows`` on the transposed ``[B*HW, K]``
    patch matrix (read in place; timed with a cold L2, see ``graph_ms``),
    ``unpack_gemm`` on the binarized patches (exact) and on the real ones
    (within rtol 1e-5 / atol 1e-4 of the float64-accumulated dot),
    ``direct_conv`` at the five convs (beside a bf16 ``F.conv2d``). Inputs in [-1, 1] with some 0.0
    and -0.0, as the clipped activations the layers encode. ``summed``:
    these are the main path's shapes, whose times make the kernels'
    totals."""
    from repro_torch.core import bitops
    from repro_torch.kernels import ops
    from repro_torch.roofline import op_cost

    gen = torch.Generator(device=dev).manual_seed(2 + batch)
    cpu_gen = torch.Generator().manual_seed(3 + batch)
    F = torch.nn.functional
    tag = f" b{batch}"
    layers = [(label, 9 * c, batch * h * h, d) for label, h, c, d in conv_cases()]
    layers += [("fc0", 8192, batch, 1024), ("fc1", 1024, batch, 1024),
               ("head", 1024, batch, 10)]
    for label, k, n, m in layers:
        x2d = torch.rand((n, k), generator=gen, device=dev) * 2 - 1
        x2d.view(-1)[::97] = 0.0
        x2d.view(-1)[::89] = -0.0
        xt = x2d.T                                   # [K, N], K-contiguous
        err = check_equal("pack_rows", label + tag, ops.pack_rows(xt),
                          bitops.pack_bits(xt, axis=0).contiguous())
        row = record(
            totals["pack_rows"], "pack_rows", f"{label} [{k},{n}]", err,
            lambda: ops.pack_rows(xt), lambda: bitops.pack_bits(xt, axis=0),  # noqa: B023
            None, k * n * 4 + k * n // 8, k * n, summed=summed, cold=True)
        # The copy reading the view in place avoids.
        row["contiguous_copy_ms"] = graph_ms(xt.contiguous, iters=5)
        rows.append(row)

        wp = rand_words(cpu_gen, (m, k // 32), dev)
        xpm = torch.sign(x2d) + (x2d == 0).float()   # the layer's binarize
        xpt = xpm.T
        run = lambda: ops.unpack_gemm(wp, xpt)  # noqa: E731,B023
        twin = lambda: bitops.packed_matmul_unpack(  # noqa: E731
            wp, xpt, compute_dtype=torch.float32)  # noqa: B023
        err = check_equal("unpack_gemm", label + tag, run(), twin())
        ref64 = bitops.packed_matmul_unpack(wp, xt, compute_dtype=torch.float32,
                                            accum_dtype=torch.float64)
        real = ops.unpack_gemm(wp, xt).double()
        dev_err = (real - ref64).abs()
        bad = int((dev_err > 1e-4 + 1e-5 * ref64.abs()).sum())
        twin32 = bitops.packed_matmul_unpack(wp, xt, compute_dtype=torch.float32)
        twin_err = float((twin32.double() - ref64).abs().max())
        print(f"  unpack_gemm real input {label}{tag}: max |kernel - f64 dot| "
              f"{float(dev_err.max()):.3g} ({bad} outside rtol 1e-5/atol 1e-4), "
              f"fp32 twin {twin_err:.3g}, |kernel - fp32 twin| "
              f"{float((real - twin32.double()).abs().max()):.3g}", flush=True)
        if bad:
            fail(f"unpack_gemm {label}{tag}: {bad} outputs on real input outside "
                 "rtol 1e-5 / atol 1e-4 of the float64-accumulated dot")
        wf = bitops.unpack_bits(wp, axis=-1)
        row = record(totals["unpack_gemm"], "unpack_gemm", f"{label} [{m},{k}]x[{k},{n}]",
                     err, run, twin, lambda: torch.matmul(wf, xpt),  # noqa: B023
                     (m * k // 32 + k * n + m * n) * 4, op_cost.gemm_flops(m, k, n),
                     summed=summed)
        row["real_input_max_abs_err"] = float(dev_err.max())
        totals["unpack_gemm"]["real_input_max_abs_err"] = max(
            totals["unpack_gemm"].get("real_input_max_abs_err", 0.0),
            row["real_input_max_abs_err"])
        rows.append(row)

    for label, h, c, d in conv_cases():
        cw, k_bits = c // 32, 9 * c
        x = rand_words(cpu_gen, (batch, h, h, cw), dev)
        w = rand_words(cpu_gen, (d, 9 * cw), dev)
        run = lambda: ops.direct_conv(w, x, k_bits, kh=3, kw=3, stride=1, pad=1)  # noqa: E731,B023
        twin = lambda: bitops.direct_conv_dot(  # noqa: E731
            w, x, k_bits, kh=3, kw=3, stride=1, pad=1)  # noqa: B023
        want = twin()
        err = check_equal("direct_conv", label + tag, run(), want)
        # Yardsticks: F.conv2d of the ±1 map, pre-padded with +1 (the
        # binary border), and the ±1 filters, NCHW, TF32 off; and the same
        # in bf16 (a timing yardstick only: its outputs round).
        xf = F.pad(bitops.unpack_bits(x, axis=-1).permute(0, 3, 1, 2),
                   (1, 1, 1, 1), value=1.0).contiguous()
        wf = bitops.unpack_bits(w, axis=-1).reshape(d, 3, 3, c).permute(
            0, 3, 1, 2).contiguous()
        xh, wh = xf.bfloat16(), wf.bfloat16()
        rows.append(record(
            totals["direct_conv"], "direct_conv", label + tag, err, run, twin,
            lambda: F.conv2d(xf, wf),  # noqa: B023
            (x.numel() + w.numel() + batch * h * h * d) * 4,
            2 * batch * h * h * d * k_bits, plain_reps=2, summed=summed,
            lib_bf16=lambda: F.conv2d(xh, wh)))  # noqa: B023


# jamba-1.5-large's decode step through the packed GEMM (ROADMAP A7b): one
# expert's [8192, 8192] projection, packed, at batch 4 with bf16
# activations, as ``bit_linear`` passes them (the transposed [4, 8192]).
DECODE_CASE = ("jamba decode", 8192, 8192, 4)


def unpack_decode_phase(dev, totals: dict, rows: list) -> None:
    """``unpack_gemm`` at ``DECODE_CASE``: exact on ±1/0 input, within
    rtol 1e-5 / atol 1e-4 of the float64 dot on real input in [-1, 1];
    timed beside bf16 ``torch.matmul`` on the unpacked bf16 weights. Off
    the main path: not summed."""
    from repro_torch.core import bitops
    from repro_torch.kernels import ops
    from repro_torch.roofline import op_cost

    label, m, k, n = DECODE_CASE
    gen = torch.Generator(device=dev).manual_seed(5)
    wp = rand_words(torch.Generator().manual_seed(6), (m, k // 32), dev)
    x2d = torch.rand((n, k), generator=gen, device=dev) * 2 - 1
    xpt = (torch.sign(x2d) + (x2d == 0).float()).to(torch.bfloat16).T
    xt = x2d.to(torch.bfloat16).T
    run = lambda: ops.unpack_gemm(wp, xpt)  # noqa: E731
    twin = lambda: bitops.packed_matmul_unpack(  # noqa: E731
        wp, xpt, compute_dtype=torch.bfloat16)
    err = check_equal("unpack_gemm", label, run(), twin())
    ref64 = bitops.packed_matmul_unpack(wp, xt, compute_dtype=torch.bfloat16,
                                        accum_dtype=torch.float64)
    dev_err = (ops.unpack_gemm(wp, xt).double() - ref64).abs()
    bad = int((dev_err > 1e-4 + 1e-5 * ref64.abs()).sum())
    print(f"  unpack_gemm real input {label}: max |kernel - f64 dot| "
          f"{float(dev_err.max()):.3g} ({bad} outside rtol 1e-5/atol 1e-4)",
          flush=True)
    if bad:
        fail(f"unpack_gemm {label}: {bad} outputs on real input outside "
             "rtol 1e-5 / atol 1e-4 of the float64-accumulated dot")
    wb = bitops.unpack_bits(wp, axis=-1, dtype=torch.bfloat16)
    row = record(totals["unpack_gemm"], "unpack_gemm",
                 f"{label} [{m},{k}]x[{k},{n}] bf16", err, run, twin,
                 lambda: torch.matmul(wb, xpt), m * k // 8 + k * n * 2 + m * n * 4,
                 op_cost.gemm_flops(m, k, n), summed=False)
    row["real_input_max_abs_err"] = float(dev_err.max())
    rows.append(row)


def preset_twins() -> dict:
    """The plain twin of each kernel a Table 2 preset launches, called as
    its wrapper calls it on CPU tensors."""
    from repro_torch.core import bitops

    return {
        "pack_rows": lambda x: bitops.pack_bits(x, axis=0).contiguous(),
        "xnor_gemm": bitops.xnor_popcount_matmul,
        "direct_conv": bitops.direct_conv_dot,
        "unpack_gemm": lambda wp, x: bitops.packed_matmul_unpack(
            wp, x, compute_dtype=x.dtype),
    }


@contextlib.contextmanager
def recorded_calls(names):
    """Within the block, every call of the wrappers ``names`` of
    ``repro_torch.kernels.ops`` is kept as (name, args, kwargs, output);
    the wrappers are restored on exit. The recorded launches are the
    forward's own: none is added."""
    from repro_torch.kernels import ops

    calls, originals = [], {name: getattr(ops, name) for name in names}

    def recording(name, wrapper):
        def call(*args, **kwargs):
            out = wrapper(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return call

    for name, wrapper in originals.items():
        setattr(ops, name, recording(name, wrapper))
    try:
        yield calls
    finally:
        for name, wrapper in originals.items():
            setattr(ops, name, wrapper)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def device_breakdown(fn, top: int = 6, warm: bool = True) -> list:
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``),
    the ``top`` largest as ``[name, ms, share]``, after one warm-up call
    (``warm``; without, for a ``fn`` already warm). The profile is
    diagnostic: an error of the profiler itself gives "not measured", but
    an error of ``fn`` (a kernel or a wrapper) propagates."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:
        return f"not measured: {err!r}"
    stop_error = None
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except Exception as err:
            stop_error = err
    if stop_error is not None:
        return f"not measured: {stop_error!r}"
    try:
        events = prof.key_averages()
    except Exception as err:
        return f"not measured: {err!r}"
    times = {}
    for evt in events:
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us:
            times[evt.key] = times.get(evt.key, 0.0) + us / 1e3
    total = sum(times.values()) or 1.0
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:60], ms, ms / total] for name, ms in ranked] + [["total", total, 1.0]]


def table2_phase(dev) -> dict:
    """Table 2 on the card: the six presets on the trained checkpoint at
    Table 2's batch, each preset's launches counted over one forward. Every
    kernel call of that forward is held, bit for bit, against its plain
    twin on the same inputs; the eager time is the mean over the
    experiment's ``num_batches`` forwards."""
    from repro_torch.configs.bnn_cifar import PRESETS, BNNExperiment
    from repro_torch.core.binarize import QuantMode
    from repro_torch.core.bnn import (bnn_apply, bnn_apply_fused,
                                      load_binary_checkpoint, pack_bnn_params,
                                      pack_bnn_params_fused)
    from repro_torch.kernels import ops

    exp = BNNExperiment("table2")
    batch = exp.batch
    twins = preset_twins()
    latent = load_binary_checkpoint(CKPT, device=dev)
    latent_cpu = load_binary_checkpoint(CKPT, device="cpu")
    packed = pack_bnn_params(latent)
    images = np.random.default_rng(64).normal(size=(batch, 32, 32, 3)).astype(
        np.float32)
    x = torch.from_numpy(images).to(dev)
    result = {"experiment": exp.name, "batch": batch,
              "num_batches": exp.num_batches, "launches": {}, "presets": {}}
    with torch.inference_mode():
        ref = bnn_apply_fused(pack_bnn_params_fused(latent), x, engine="xla")
        for name, cfg in PRESETS.items():
            is_packed = cfg.mode == QuantMode.PACKED
            params = packed if is_packed else latent
            fwd = lambda: bnn_apply(params, x, cfg)  # noqa: E731,B023
            # This preset's counts: 0 just before its checked forward,
            # read just after.
            ops.reset_launches()
            with recorded_calls(twins) as calls:
                logits = fwd()
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            result["launches"][name] = launches
            if launches != launches_per_forward(name):
                fail(f"{name}: kernel launches {launches} in one forward, "
                     f"expected {launches_per_forward(name)}")
            for i, (kname, args, kwargs, out) in enumerate(calls):
                check_equal(kname, f"{name} call {i}", out,
                            twins[kname](*args, **kwargs))
            row = {"weight_bytes": _nbytes(params),
                   "kernel_calls_checked": len(calls)}
            del calls
            if logits.shape != (batch, 10) or not torch.isfinite(logits).all():
                fail(f"{name}: logits {tuple(logits.shape)} not finite [{batch}, 10]")
            if name != "CONTROL_GROUP":
                if not torch.equal(logits, ref):
                    fail(f"{name}: logits differ from the fused xla forward "
                         f"(max abs {float((logits - ref).abs().max())})")
                check = "bit-identical to fused xla"
            else:
                # Float layers pad borders with 0, not +1: its own logits.
                cpu = bnn_apply(latent_cpu, torch.from_numpy(images[:4]), cfg)
                diff = float((logits[:4].cpu() - cpu).abs().max())
                row["cpu_vs_gpu_max_abs"] = diff
                if not torch.allclose(logits[:4].cpu(), cpu, rtol=1e-5,
                                      atol=1e-4) or not torch.equal(
                                          logits[:4].cpu().argmax(1), cpu.argmax(1)):
                    fail(f"{name}: card logits disagree with the CPU forward "
                         f"(max abs {diff})")
                check = f"within {diff:.3g} of its CPU forward on 4 images"
            row["eager_ms"] = time_ms(fwd, iters=exp.num_batches, reps=3)
            row["graph_ms"] = graph_ms(fwd, iters=3)
            row["device_breakdown"] = device_breakdown(fwd)
            result["presets"][name] = row
            if row["kernel_calls_checked"]:
                check += (f"; its {row['kernel_calls_checked']} kernel calls "
                          "equal their twins")
            print(f"  {name:13s} {check}; launches/forward "
                  f"{ {k: v for k, v in launches.items() if v} }; device "
                  f"{row['graph_ms']:.3f} ms (graph), eager {row['eager_ms']:.3f} "
                  f"ms; weights {row['weight_bytes']} B", flush=True)
            if isinstance(row["device_breakdown"], str):
                print(f"    profile {row['device_breakdown']}", flush=True)
            else:
                for kname, ms, share in row["device_breakdown"]:
                    print(f"    {ms:8.4f} ms {share:6.1%}  {kname}", flush=True)
    p = result["presets"]
    for kind in ("graph_ms", "eager_ms"):
        result[f"control_over_paper_{kind}"] = (
            p["CONTROL_GROUP"][kind] / p["PAPER_KERNEL"][kind])
    print(f"  CONTROL_GROUP / PAPER_KERNEL at batch {batch}: "
          f"{result['control_over_paper_graph_ms']:.3f}x device, "
          f"{result['control_over_paper_eager_ms']:.3f}x eager", flush=True)
    return result


# Phase 6: one full-width period of jamba-1.5-large-398b, served.
JAMBA_LAYERS, JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN = 8, 4, 512, 8
# Kernel path vs twin path, |diff| <= atol + rtol * |twin logit|. Stated
# before the first run on the card, for bf16 activations: the kernel sums
# y over the state in another order than the twin, so a y can move by an
# ulp; where that crosses a bf16 rounding boundary an activation moves by
# 2^-8 of itself, and such moves pass through 8 layers (and could tip a
# near-tied MoE top-2 choice). Logits are O(1) (|logit| up to ~5 for an
# RMS-normed x against N(0, 1/d) head rows); a wrong kernel is caught by
# the per-call checks at 1e-5 and moves logits by far more.
JAMBA_LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)
# The same comparison for the prefill with float32 activations (the
# config's dtype replaced; same params): no bf16 rounding to amplify an
# ulp of y, so only float32 reassociation through 8 layers remains.
JAMBA_F32_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def _proj_bytes(tree) -> tuple[int, int]:
    """(bytes of the packed projection weights and their alphas, bytes of
    the same weights in bfloat16)."""
    if isinstance(tree, list):
        parts = [_proj_bytes(v) for v in tree]
    elif isinstance(tree, dict) and "w_packed" in tree:
        w = tree["w_packed"]
        alpha = tree.get("alpha")
        packed = w.numel() * 4 + (alpha.numel() * 4 if alpha is not None else 0)
        return packed, w.numel() * 32 * 2
    elif isinstance(tree, dict):
        parts = [_proj_bytes(v) for v in tree.values()]
    else:
        return 0, 0
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def events_ms(fn, reps: int = 3, warm: bool = True) -> float:
    """Median device-clock time of one call (CUDA events around it) after
    one warm-up call (``warm``; without, for a ``fn`` already warm)."""
    if warm:
        fn()
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


def jamba_phase(dev, cfg=None) -> dict:
    """Serve one full-width period of jamba-1.5-large-398b (8 layers: 7
    mamba, 1 attention; 4 MoE of 16 experts, 4 dense FFNs; vocab 65536)
    from 1-bit packed weights through ``launch.serve.serve_config``:
    ``init_packed`` on the card from a seeded generator, batch 4, a
    512-token prompt (two scan chunks), 8 greedy tokens, f32 KV cache.

    The launch counts are 0 just before the prefill and read after it
    (14 scan launches, nothing else) and after each decode step (none);
    every scan call of the prefill is held against its twin on its own
    inputs. The same model is run again with the twin in place of the
    kernel (swapped here, for that run only), teacher-forced with the
    kernel path's tokens, and its logits held to ``JAMBA_LOGIT_TOL``."""
    import dataclasses

    from repro_torch.configs.base import get_config, serve_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssm_scan_chunk_ref
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.model_factory import build_model

    if cfg is None:
        cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                                  num_layers=JAMBA_LAYERS)
    policy = serve_policy()
    model = build_model(cfg, policy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = model.init_packed(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    packed_b, bf16_b = _proj_bytes(params)
    result = {"config": {"name": cfg.name, "num_layers": cfg.num_layers,
                         "d_model": cfg.d_model, "num_experts": cfg.num_experts,
                         "vocab_size": cfg.vocab_size, "dtype": str(cfg.dtype)},
              "init_packed_s": time.monotonic() - t0,
              "packed_weight_bytes": packed_b, "bf16_weight_bytes": bf16_b,
              "param_bytes": _nbytes(params)}
    print(f"  init_packed: {result['init_packed_s']:.1f} s; projection weights "
          f"{packed_b / 1e9:.3f} GB packed (with alphas) vs {bf16_b / 1e9:.1f} "
          f"GB in bf16 ({bf16_b / packed_b:.1f}x); all params "
          f"{result['param_bytes'] / 1e9:.2f} GB", flush=True)

    logits_k, launches = [], []

    def on_step(step, logits):
        torch.cuda.synchronize()
        launches.append(dict(ops.LAUNCHES))
        ops.reset_launches()
        logits_k.append(logits.float().clone())

    with recorded_calls(["ssm_scan_chunk"]) as calls:
        # The counts: 0 just before the prefill (serve_config launches
        # nothing before it), read after it and after each decode step.
        ops.reset_launches()
        served = serve_config(cfg, policy, batch=JAMBA_BATCH,
                              prompt_len=JAMBA_PROMPT, gen=JAMBA_GEN, seed=0,
                              cache_dtype=torch.float32, device=dev,
                              params=params, on_step=on_step)
    n_mamba = sum(not cfg.is_attention_layer(i) for i in range(cfg.num_layers))
    chunks = -(-JAMBA_PROMPT // 256)
    want = {**dict.fromkeys(ops.LAUNCHES, 0), "ssm_scan_chunk": n_mamba * chunks}
    if launches[0] != want:
        fail(f"jamba prefill: launches {launches[0]}, expected {want}")
    for step, counts in enumerate(launches[1:], start=1):
        if any(counts.values()):
            fail(f"jamba decode step {step}: launches {counts}, expected none")
    if len(calls) != want["ssm_scan_chunk"]:
        fail(f"jamba: {len(calls)} scan calls recorded, expected "
             f"{want['ssm_scan_chunk']}")
    result["launches"] = {"prefill": launches[0], "decode": launches[1:]}
    result["scan_calls_max_abs_err"] = max(
        scan_error("ssm_scan_chunk", f"jamba prefill call {i}", out,
                   ssm_scan_chunk_ref(*args, **kwargs))
        for i, (_, args, kwargs, out) in enumerate(calls))
    del calls
    tokens = served["tokens"]
    if tokens.shape != (JAMBA_BATCH, JAMBA_GEN) or len(logits_k) != JAMBA_GEN:
        fail(f"jamba: tokens {tuple(tokens.shape)}, {len(logits_k)} logit steps")
    for step, lg in enumerate(logits_k):
        if lg.shape != (JAMBA_BATCH, cfg.vocab_size) or not torch.isfinite(lg).all():
            fail(f"jamba step {step}: logits {tuple(lg.shape)} not finite "
                 f"[{JAMBA_BATCH}, {cfg.vocab_size}]")
    print(f"  served {JAMBA_BATCH} x {JAMBA_PROMPT} prompt + {JAMBA_GEN} tokens: "
          f"prefill launched {launches[0]['ssm_scan_chunk']} scans "
          f"({n_mamba} mamba layers x {chunks} chunks), each within "
          f"{result['scan_calls_max_abs_err']:.2g} of its twin; decode steps "
          f"none; host clock prefill {served['prefill_s']:.3f} s, decode "
          f"{served['decode_s']:.3f} s", flush=True)

    # The same model with the plain twin in place of the kernel,
    # teacher-forced with the kernel path's tokens.
    prompts = served["prompts"]
    state0 = model.init_state(JAMBA_BATCH, JAMBA_PROMPT + JAMBA_GEN,
                              dtype=torch.float32, device=dev)

    def run(m, scan, steps):
        """Logits of the prefill and ``steps`` teacher-forced decode steps
        of model ``m`` with ``scan`` as ``ops.ssm_scan_chunk``."""
        kernel = ops.ssm_scan_chunk
        ops.ssm_scan_chunk = scan
        try:
            with torch.inference_mode():
                lg, state = m.prefill(params, state0, {"tokens": prompts})
                out = [lg.float()]
                for step in range(steps):
                    lg, state = m.decode_step(
                        params, state, {"tokens": tokens[:, step:step + 1]})
                    out.append(lg.float())
        finally:
            ops.ssm_scan_chunk = kernel
        return out

    def held(what, got, want, tol) -> list:
        errs = []
        for step, (k, t) in enumerate(zip(got, want)):
            diff = (k - t).abs()
            errs.append(float(diff.max()))
            bad = int((diff > tol["atol"] + tol["rtol"] * t.abs()).sum())
            if bad:
                fail(f"jamba {what} step {step}: {bad} logits outside {tol} "
                     f"(max abs diff {errs[-1]:.3g})")
        return errs

    logits_t = run(model, ssm_scan_chunk_ref, JAMBA_GEN - 1)
    errs = held("kernel vs twin path", logits_k, logits_t, JAMBA_LOGIT_TOL)
    agree = sum(int((k.argmax(-1) == t.argmax(-1)).sum())
                for k, t in zip(logits_k, logits_t))
    # Diagnostics: the kernel path's prefill once more (run to run), and
    # kernel vs twin prefill with float32 activations.
    rerun = run(model, ops.ssm_scan_chunk, 0)
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32), policy)
    f32_k = run(model32, ops.ssm_scan_chunk, 0)
    f32_t = run(model32, ssm_scan_chunk_ref, 0)
    f32_errs = held("float32-activation prefill, kernel vs twin", f32_k, f32_t,
                    JAMBA_F32_LOGIT_TOL)
    result.update(logits_max_abs_diff=errs,
                  logits_abs_max=float(max(t.abs().max() for t in logits_t)),
                  greedy_agreement=f"{agree}/{JAMBA_BATCH * JAMBA_GEN}",
                  prefill_rerun_max_abs_diff=float((rerun[0] - logits_k[0]).abs().max()),
                  f32_prefill_max_abs_diff=f32_errs[0])
    print(f"  kernel vs twin path (bf16 activations): max |logit diff| per step "
          f"{[f'{e:.3g}' for e in errs]} (|logits| up to "
          f"{result['logits_abs_max']:.3g}; tolerance {JAMBA_LOGIT_TOL}); greedy "
          f"tokens agree {result['greedy_agreement']}; kernel path prefill run "
          f"again: max |diff| {result['prefill_rerun_max_abs_diff']:.3g}; "
          f"float32 activations, kernel vs twin prefill: max |diff| "
          f"{f32_errs[0]:.3g} (tolerance {JAMBA_F32_LOGIT_TOL})", flush=True)
    del model32, f32_k, f32_t, rerun

    # Device-clock times (CUDA events) and profiles of one prefill and one
    # decode step (functional: the state given is not written).
    with torch.inference_mode():
        batch_p = {"tokens": prompts}
        batch_d = {"tokens": tokens[:, -1:]}
        _, state1 = model.prefill(params, state0, batch_p)
        result["prefill_ms"] = events_ms(
            lambda: model.prefill(params, state0, batch_p), reps=2)
        result["decode_ms_per_token"] = events_ms(
            lambda: model.decode_step(params, state1, batch_d), reps=3)
        result["prefill_breakdown"] = device_breakdown(
            lambda: model.prefill(params, state0, batch_p))
        result["decode_breakdown"] = device_breakdown(
            lambda: model.decode_step(params, state1, batch_d))
    result["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print(f"  prefill {result['prefill_ms']:.1f} ms, decode "
          f"{result['decode_ms_per_token']:.1f} ms per token (batch "
          f"{JAMBA_BATCH}; CUDA events); max_memory_allocated "
          f"{result['max_memory_allocated'] / 1e9:.2f} GB", flush=True)
    for what in ("prefill", "decode"):
        top = result[f"{what}_breakdown"]
        print(f"    {what} profile: "
              + (top if isinstance(top, str) else ""), flush=True)
        if not isinstance(top, str):
            for kname, ms, share in top:
                print(f"    {ms:10.3f} ms {share:6.1%}  {kname}", flush=True)
    return result


# Phase 7: the LM training forward (Model.loss) at full width.
# (arch, batch, kernel it must launch, launches per forward, whether its
# bf16 logits are held to LM_LOGIT_TOL, layers or None for all): the
# train_4k shape's sequence of 4096 tokens, its batch of 256 cut to 4 /
# 2; xlstm-1.3b cut to one 8-layer period (7 mLSTM + 1 sLSTM), as phase
# 11 trains it (at 48 layers its forward took ~12 s a call, the sLSTM
# loop's). xlstm-1.3b's bf16 logits
# are reported, not held: on an H100 a one-float32-ulp nudge of the
# mLSTM output in the twin path moves them by 3.1 (more than the kernel
# does), so they measure the random-weight model's bf16 sensitivity, not
# the kernel. Its kernel is held per call, by the bf16 loss and by the
# float32-activation logits and loss.
LM_CASES = [("smollm-360m", 4, "flash_attention", 32, True, None),
            ("xlstm-1.3b", 2, "mlstm_chunked", 7, False, 8)]
LM_SEQ = 4096
# Kernel path vs twin path, bf16 activations: |loss diff| <= LM_LOSS_TOL
# and |logit diff| <= atol + rtol * |twin logit|. Stated before the first
# run on the card: the kernels differ from their twins by float32 ulps
# (flash: an occasional bf16 flip of p); where such a difference crosses
# a bf16 rounding boundary of an activation it moves by 2^-8 of itself,
# and such moves pass through 32 / 48 layers. On the CPU the smoke smollm
# (2 layers, bf16) moves its logits by 0.045 when only the twin's KV
# block changes (512 to 64). Logits are O(1) (RMS-normed x against
# N(0, 1/d) head rows, |logit| up to ~6); a wrong kernel is caught by the
# per-call checks and moves logits by O(1) everywhere.
LM_LOSS_TOL = 2e-2
LM_LOGIT_TOL = dict(rtol=0.1, atol=0.5)
# The same loss with float32 activations (same params): no bf16 rounding
# to amplify the kernels' float32 ulps. The logits' limit is set from
# the readings on an H100 (xlstm-1.3b 1.7e-3, smollm-360m 1.1e-5): some
# 6x the larger, far below the O(1) a wrong kernel gives.
LM_F32_LOSS_TOL = 1e-3
LM_F32_LOGIT_TOL = dict(rtol=0.0, atol=1e-2)


def logit_diff(got: torch.Tensor, want: torch.Tensor, seq: int,
               tol: dict) -> dict:
    """|got - want| of two ``[B, S, V]`` logit tensors: the max, the max
    over position ranges, the count outside ``tol`` (``atol + rtol *
    |want|``) and the share of positions whose argmax agrees."""
    diff = (got - want).abs()
    per_pos = diff.amax(dim=(0, 2))
    edges = [e for e in (0, 64, 256, 1024, seq) if e <= seq]
    tol = tol["atol"] + tol["rtol"] * want.abs()
    return {"max_abs_diff": float(diff.max()),
            "by_position": {f"{a}-{b}": round(float(per_pos[a:b].max()), 4)
                            for a, b in zip(edges[:-1], edges[1:]) if b > a},
            "abs_max": float(want.abs().max()),
            "outside_tol": int((diff > tol).sum()),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean())}


@contextlib.contextmanager
def checked_calls(name: str, check):
    """Within the block, every call of ``ops.<name>`` is held against its
    twin at once (``check(label, args, kwargs, out)`` returns the call's
    error), so the calls' operands need not be kept; yields the list of
    errors. The forward's own launches are the only ones counted: twins
    launch no kernel."""
    from repro_torch.kernels import ops

    errors, wrapper = [], getattr(ops, name)

    def call(*args, **kwargs):
        out = wrapper(*args, **kwargs)
        errors.append(check(f"call {len(errors)}", args, kwargs, out))
        return out

    setattr(ops, name, call)
    try:
        yield errors
    finally:
        setattr(ops, name, wrapper)


@contextlib.contextmanager
def captured_logits():
    """Within the block, the logits of the last ``lm_forward`` call are
    kept in the yielded list, so one ``Model.loss`` gives its loss and its
    logits."""
    from repro_torch.models import transformer as tf_mod

    kept, forward = [], tf_mod.lm_forward

    def call(*args, **kwargs):
        out = forward(*args, **kwargs)
        kept[:] = [out[0]]
        return out

    tf_mod.lm_forward = call
    try:
        yield kept
    finally:
        tf_mod.lm_forward = forward


@contextlib.contextmanager
def twins_in_place():
    """Within the block the two LM kernels' wrappers are their plain twins
    (flash with the kernel's KV tile)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlstm_chunked_ref

    saved = ops.flash_attention, ops.mlstm_chunked
    ops.flash_attention, ops.mlstm_chunked = flash_twin, mlstm_chunked_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.mlstm_chunked = saved


def lm_phase(dev, cases=LM_CASES, seq: int = LM_SEQ) -> dict:
    """``Model.loss`` of smollm-360m (batch 4) and one 8-layer period of
    xlstm-1.3b (batch 2) at full width and S 4096 on the card, under
    ``train_policy()`` (fake-quant
    ±1 weights with the XNOR-Net alpha), on random float32 params from a
    seeded generator and a batch of ``synthetic_lm_batches``.

    The launch counts are 0 just before the loss forward and read after
    it: smollm must launch ``flash_attention`` 32 times, xlstm
    ``mlstm_chunked`` 7 times, and nothing else. Every kernel call of that
    forward is held against its twin on its own inputs. The loss and the
    logits (``lm_forward``) are held to the same model run with the twins
    in place of the kernels: the loss within ``LM_LOSS_TOL``, the logits
    within ``LM_LOGIT_TOL`` where the case says so (see ``LM_CASES``), and
    with float32 activations the loss within ``LM_F32_LOSS_TOL`` and the
    logits within ``LM_F32_LOGIT_TOL``. Loss and logits come from one
    ``Model.loss`` (``captured_logits``). Where the bf16 logits are past
    ``LM_LOGIT_TOL``, diagnostics: the kernel path run again, and for the
    mLSTM the twin path with y one float32 ulp up. Prints the loss, the
    forward's ms (CUDA events), peak memory and a profile."""
    import dataclasses

    from repro_torch.configs.base import get_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlstm_chunked_ref
    from repro_torch.models.model_factory import build_model

    def check(kernel):
        def held(label, args, kwargs, out):
            with torch.no_grad():
                if kernel == "flash_attention":
                    return flash_error(label, out, flash_twin(*args, **kwargs))
                return mlstm_error(label, out, mlstm_chunked_ref(*args, **kwargs))
        return held

    results = {}
    for arch, batch_size, kernel, per_forward, hold_bf16_logits, layers in cases:
        if isinstance(arch, str):
            cfg = get_config(arch)
        else:
            cfg, arch = arch, arch.name
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        policy = train_policy()
        model = build_model(cfg, policy)
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        batch = next(synthetic_lm_batches(DataConfig(
            seed=0, global_batch=batch_size, seq_len=seq,
            vocab_size=cfg.vocab_size)))
        batch = {"tokens": batch["tokens"].to(dev),
                 "labels": batch["labels"].to(dev)}
        res = {"config": {"name": cfg.name, "num_layers": cfg.num_layers,
                          "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                          "dtype": str(cfg.dtype)},
               "batch": [batch_size, seq], "init_s": time.monotonic() - t0,
               "param_bytes": _nbytes(params)}

        def run(m):
            """(total, loss, logits) of one ``Model.loss``."""
            with torch.no_grad(), captured_logits() as kept:
                total, parts = m.loss(params, batch)
            return float(total), float(parts["loss"]), kept[0]

        with checked_calls(kernel, check(kernel)) as errors:
            ops.reset_launches()
            total, loss, logits_k = run(model)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
        want = {**dict.fromkeys(ops.LAUNCHES, 0), kernel: per_forward}
        if launches != want:
            fail(f"{arch} loss forward: launches {launches}, expected {want}")
        if len(errors) != per_forward or not np.isfinite(total):
            fail(f"{arch}: {len(errors)} {kernel} calls checked, loss {total}")
        res.update(launches=launches, loss=loss, total=total,
                   calls_checked=len(errors),
                   calls_max_abs_err=max(e["max_abs_err"] for e in errors))
        if kernel == "mlstm_chunked":
            res["calls_max_of_limit"] = max(e["max_of_limit"] for e in errors)
        if kernel == "flash_attention":
            res.update(calls_max_row_ulps=max(e["max_row_ulps"] for e in errors),
                       calls_max_elem_ulps=max(e["max_elem_ulps"] for e in errors),
                       calls_max_share_past_own_ulp=max(
                           e["elements_past_own_ulp"] / e["elements"] for e in errors))
        shape = (batch_size, seq, cfg.padded_vocab)
        if logits_k.shape != shape or not torch.isfinite(logits_k).all():
            fail(f"{arch}: logits {tuple(logits_k.shape)}, expected {shape}, "
                 f"finite={bool(torch.isfinite(logits_k).all())}")
        with twins_in_place():
            _, loss_t, logits_t = run(model)
        res.update(twin_loss=loss_t, loss_diff=abs(loss - loss_t),
                   logits=logit_diff(logits_k, logits_t, seq, LM_LOGIT_TOL))
        if res["logits"]["outside_tol"]:
            # Diagnostics of a bf16 gap past LM_LOGIT_TOL: the kernel path
            # again (run to run), and for the mLSTM the twin path with y one
            # float32 ulp up (the model's own sensitivity to an ulp of the
            # kernel's output).
            res["rerun_logits_max_abs_diff"] = float(
                (run(model)[2] - logits_k).abs().max())
            if kernel == "mlstm_chunked":
                def nudged(*args, **kwargs):
                    y, *rest = mlstm_chunked_ref(*args, **kwargs)
                    return (torch.nextafter(y, torch.full_like(y, float("inf"))),
                            *rest)
                with twins_in_place():
                    ops.mlstm_chunked = nudged
                    res["nudged_twin_logits"] = logit_diff(
                        run(model)[2], logits_t, seq, LM_LOGIT_TOL)
        del logits_k, logits_t
        model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32), policy)
        _, f32_k, f32_logits_k = run(model32)
        with twins_in_place():
            _, f32_t, f32_logits_t = run(model32)
        res["f32_logits"] = logit_diff(f32_logits_k, f32_logits_t, seq,
                                       LM_F32_LOGIT_TOL)
        del f32_logits_k, f32_logits_t
        res.update(f32_loss=f32_k, f32_loss_diff=abs(f32_k - f32_t))
        lg = res["logits"]
        print(f"  {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, batch "
              f"{batch_size} x {seq}, params {res['param_bytes'] / 1e9:.2f} GB "
              f"float32): loss {loss:.6f} (total {total:.6f}); launched "
              f"{launches[kernel]} {kernel} and nothing else, every call within "
              f"{res['calls_max_abs_err']:.3g} of its twin"
              + (f" ({res['calls_max_row_ulps']:.2f} row ulps, "
                 f"{res['calls_max_elem_ulps']:.2f} own ulps, at most "
                 f"{res['calls_max_share_past_own_ulp']:.2e} of a call past one)"
                 if "calls_max_row_ulps" in res else "")
              + (f" ({res['calls_max_of_limit']:.2f} of the limit)"
                 if "calls_max_of_limit" in res else "")
              + f"; twin path loss {loss_t:.6f} (|diff| {res['loss_diff']:.3g}), "
              f"max |logit diff| {lg['max_abs_diff']:.3g} by position "
              f"{lg['by_position']} (|logits| up to {lg['abs_max']:.3g}, "
              f"{lg['outside_tol']} outside {LM_LOGIT_TOL}), argmax agree "
              f"{lg['argmax_agreement']:.4f}"
              + (f"; kernel path again: max |diff| "
                 f"{res['rerun_logits_max_abs_diff']:.3g}"
                 if "rerun_logits_max_abs_diff" in res else "")
              + (f"; twin path with y one ulp up: max |logit diff| "
                 f"{res['nudged_twin_logits']['max_abs_diff']:.3g} by position "
                 f"{res['nudged_twin_logits']['by_position']}"
                 if "nudged_twin_logits" in res else "")
              + f"; float32 activations: loss {f32_k:.6f}, kernel vs twin |diff| "
              f"{res['f32_loss_diff']:.3g}, max |logit diff| "
              f"{res['f32_logits']['max_abs_diff']:.3g} by position "
              f"{res['f32_logits']['by_position']} "
              f"({res['f32_logits']['outside_tol']} outside {LM_F32_LOGIT_TOL})",
              flush=True)
        if res["loss_diff"] > LM_LOSS_TOL or (hold_bf16_logits and lg["outside_tol"]):
            fail(f"{arch}: kernel vs twin path loss {loss} vs {loss_t}, "
                 f"{lg['outside_tol']} logits outside {LM_LOGIT_TOL}")
        if res["f32_loss_diff"] > LM_F32_LOSS_TOL or res["f32_logits"]["outside_tol"]:
            fail(f"{arch}: float32 activations, kernel vs twin loss {f32_k} vs "
                 f"{f32_t}, {res['f32_logits']['outside_tol']} logits outside "
                 f"{LM_F32_LOGIT_TOL}")
        del model32
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        res["loss_ms"] = events_ms(lambda: run(model), reps=2)
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        res["loss_breakdown"] = device_breakdown(lambda: run(model), top=8)
        print(f"    loss forward {res['loss_ms']:.1f} ms (CUDA events); "
              f"max_memory_allocated {res['max_memory_allocated'] / 1e9:.2f} GB; "
              f"profile: " + (res["loss_breakdown"]
                              if isinstance(res["loss_breakdown"], str) else ""),
              flush=True)
        if not isinstance(res["loss_breakdown"], str):
            for kname, ms, share in res["loss_breakdown"]:
                print(f"    {ms:10.3f} ms {share:6.1%}  {kname}", flush=True)
        results[arch] = res
        del params
    return results


# Phase 8: steps timed by CUDA events (after warm-up steps), the
# held-out images of the export probe, and the served requests.
TRAIN_WARMUP_STEPS = 5
TRAIN_TIMED_STEPS = 20
PROBE_IMAGES = 64
USE_SCALE_STEPS = 20


def train_step_flops(batch: int) -> int:
    """Multiply-adds x 2 of one STE train step's GEMMs: the forward's, and
    the backward's two (inputs and weights) for every layer but the first
    conv, whose inputs (the images) take no gradient."""
    from repro_torch.core.bnn import CONV_CHANNELS, FC_SIZES, POOL_AFTER

    side, fwd = 32, []
    for i, (cin, cout) in enumerate(CONV_CHANNELS):
        fwd.append(2 * batch * side * side * 9 * cin * cout)
        side //= 2 if i in POOL_AFTER else 1
    fwd += [2 * batch * fin * fout for fin, fout in FC_SIZES]
    return 3 * sum(fwd) - fwd[0]


def train_phase(dev) -> dict:
    """Phase 8: the BNN's train-to-serve loop at full width on the card.

    (a) ``train_bnn`` with ``BNNTrainerConfig()``'s defaults (200 steps at
    batch 64), checkpoints every 50 steps under ``build/``; held as
    ``tests/test_train.py`` holds its trainer; beside it one train step's
    time by CUDA events, images/s, peak memory and the device's busy share
    over 20 steps (``torch.profiler``). (b) the last checkpoint deleted,
    the same run again: it resumes from step 150 and must end with every
    leaf bit-identical. (c) ``pack_trained_params`` on 64 held-out images,
    both ``conv_impl``s, of (a)'s latents and of a 20-step ``use_scale``
    run. (d) the sign-form checkpoint written and loaded on the card, its
    logits unchanged, 12 requests of 1-8 images served from it by the
    ``xnor``/direct bucket engine and the continuous megakernel engine,
    each answer equal to the float-boundary forward of its images alone.
    (e) the kernel launches of the phase (none in training)."""
    import shutil

    from repro_torch import tree
    from repro_torch.checkpoint import manager
    from repro_torch.core.bnn import (bnn_eval_logits, init_bnn_params,
                                      load_binary_checkpoint,
                                      pack_bnn_params_fused,
                                      pack_bnn_params_megakernel,
                                      pack_trained_params,
                                      save_binary_checkpoint, update_bn_stats)
    from repro_torch.data.pipeline import DataConfig, cifar_batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_bnn import random_requests
    from repro_torch.serve import (ContinuousServingEngine, ServingEngine,
                                   is_error)
    from repro_torch.train.bnn_trainer import (BNNTrainerConfig, _BNNTask,
                                               bnn_clip_predicate, train_bnn)
    from repro_torch.train.step import _grads_of, init_opt_state, make_train_step

    work = OUT_DIR / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = BNNTrainerConfig(checkpoint_dir=str(work / "ckpt"))
    result = {"config": {k: v for k, v in vars(cfg).items()
                         if k != "checkpoint_dir"}}
    try:
        # This phase's counts: 0 here, read at its end.
        ops.reset_launches()

        # (a) One step's time: the trainer's step and EMA on the stream's
        # first batches, already on the card.
        task = _BNNTask(cfg.model_config())
        step_fn = make_train_step(task, cfg.train_config(),
                                  clip_predicate=bnn_clip_predicate)
        data_cfg = DataConfig(seed=cfg.data_seed, global_batch=cfg.batch)
        n_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
        feeds = [{k: cifar_batch_at(data_cfg, i)[k].to(dev)
                  for k in ("images", "labels")} for i in range(n_steps)]
        state = [init_bnn_params(cfg.seed, device=dev), None]
        state[1] = init_opt_state(state[0])

        def steps(batches):
            for feed in batches:
                p, o, m = step_fn(state[0], state[1], feed)
                state[0] = update_bn_stats(p, m.pop("bn_stats"),
                                           momentum=cfg.bn_momentum)
                state[1] = o

        def grads(batches):
            for feed in batches:
                _grads_of(task, state[0], feed)

        def events_ms(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(feeds[TRAIN_WARMUP_STEPS:])
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / TRAIN_TIMED_STEPS

        steps(feeds[:TRAIN_WARMUP_STEPS])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = events_ms(steps)
        # The loss and its gradient alone: the rest of a step is the clip,
        # AdamW and the EMA over the params' 54 leaves.
        grad_ms = events_ms(grads)
        flops = train_step_flops(cfg.batch)
        breakdown = device_breakdown(
            lambda: steps(feeds[TRAIN_WARMUP_STEPS:]), top=12)
        device_ms = (breakdown[-1][1] / TRAIN_TIMED_STEPS
                     if not isinstance(breakdown, str) else None)
        result.update(
            step_ms=step_ms, grad_ms=grad_ms,
            images_per_s=cfg.batch * 1e3 / step_ms,
            step_flops=flops, step_bound_ms=flops / FP32_OPS_PER_S * 1e3,
            step_peak_memory=torch.cuda.max_memory_allocated(),
            step_device_ms=device_ms,
            busy_share=None if device_ms is None else device_ms / step_ms,
            step_breakdown=breakdown)
        del state, feeds
        print(f"  train step (batch {cfg.batch}): {step_ms:.3f} ms by CUDA "
              f"events over {TRAIN_TIMED_STEPS} steps after "
              f"{TRAIN_WARMUP_STEPS} (the loss and its gradient alone "
              f"{grad_ms:.3f} ms); {result['images_per_s']:.0f} images/s; "
              f"bound {result['step_bound_ms']:.3f} ms ({flops / 1e9:.1f} "
              f"GFLOP at the float32 peak); peak memory "
              f"{result['step_peak_memory'] / 1e9:.2f} GB; device busy "
              + ("not measured" if device_ms is None else
                 f"{device_ms:.3f} ms a step, share {result['busy_share']:.3f}"),
              flush=True)
        if not isinstance(breakdown, str):
            for kname, ms, share in breakdown:
                print(f"    {ms:10.3f} ms {share:6.1%}  {kname}", flush=True)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res = train_bnn(cfg, device=dev)
        torch.cuda.synchronize()
        result["train_s"] = time.monotonic() - t0
        result["train_peak_memory"] = torch.cuda.max_memory_allocated()
        loss = res.history["loss"]
        back_half = float(np.mean(loss[cfg.steps // 2:]))
        result.update(first_loss=loss[0], back_half_loss=back_half,
                      first_lr_scale=res.history["lr_scale"][0],
                      eval_loss=res.eval_loss, eval_acc=res.eval_acc)
        print(f"  train_bnn: {cfg.steps} steps in {result['train_s']:.2f} s "
              f"(host clock, data and checkpoints included); loss "
              f"{loss[0]:.4f} -> back-half mean {back_half:.4f}; held-out "
              f"loss {res.eval_loss:.4f} acc {res.eval_acc:.4f} (chance "
              f"0.10); peak memory {result['train_peak_memory'] / 1e9:.2f} GB",
              flush=True)
        if not res.history["lr_scale"][0] > 0.0:
            fail("train: the first step's lr_scale is 0")
        if not back_half < loss[0] - 0.5:
            fail(f"train: back-half mean loss {back_half} is not below the "
                 f"first loss {loss[0]} - 0.5")
        for group in ("conv", "fc"):
            for j, layer in enumerate(res.params[group]):
                if float(layer["w"].abs().max()) > 1.0:
                    fail(f"train: {group}[{j}].w left [-1, 1]")
        if not bool((res.params["bn_conv"][0]["mean"] != 0).any()):
            fail("train: bn_conv[0].mean never moved off 0")
        latest = manager.latest_valid_step(cfg.checkpoint_dir)
        if latest != cfg.steps:
            fail(f"train: latest valid checkpoint {latest}, expected {cfg.steps}")
        if not res.eval_acc > 0.10:
            fail(f"train: held-out accuracy {res.eval_acc} is not above chance")
        trained = dict(ops.LAUNCHES)
        if any(trained.values()):
            fail(f"train: training launched kernels {trained}")

        # (b) Resume from the checkpoint before the last.
        shutil.rmtree(pathlib.Path(cfg.checkpoint_dir) / f"step_{cfg.steps:08d}")
        t0 = time.monotonic()
        again = train_bnn(cfg, device=dev)
        result["resume_s"] = time.monotonic() - t0
        result["resume_from"] = again.start_step
        if again.start_step != cfg.steps - cfg.checkpoint_every:
            fail(f"resume: started at {again.start_step}")
        leaves = list(zip(tree.leaves_with_path((res.params, res.opt_state)),
                          tree.leaves((again.params, again.opt_state))))
        differ = [path for (path, a), b in leaves if not torch.equal(a, b)]
        if differ or again.history["loss"] != loss[again.start_step:]:
            fail(f"resume: leaves not bit-identical to the uninterrupted run: "
                 f"{differ[:5]} ({len(differ)} of {len(leaves)})")
        result["resume_leaves_equal"] = len(leaves)
        print(f"  resumed from step {again.start_step}: {len(leaves)} param "
              f"and optimizer leaves bit-identical ({result['resume_s']:.2f} s)",
              flush=True)

        # (c) Export under the probe, with and without alpha.
        probe = cifar_batch_at(DataConfig(seed=cfg.data_seed,
                                          global_batch=PROBE_IMAGES),
                               cfg.steps + cfg.eval_batches)["images"].to(dev)
        scaled = train_bnn(dataclasses.replace(
            cfg, steps=USE_SCALE_STEPS, use_scale=True, checkpoint_dir=None),
            device=dev)
        result["use_scale_run"] = {"steps": USE_SCALE_STEPS,
                                   "eval_acc": scaled.eval_acc,
                                   "eval_loss": scaled.eval_loss}
        for name, params, use_scale in (("trained", res.params, False),
                                        ("use_scale", scaled.params, True)):
            t0 = time.monotonic()
            try:
                packs = pack_trained_params(params, use_scale=use_scale,
                                            probe_images=probe)
            except ValueError as err:
                fail(f"export ({name}): {err}")
            result[f"export_{name}_s"] = time.monotonic() - t0
            print(f"  export ({name}, use_scale={use_scale}): packed/xla, "
                  f"fused xla+xnor x im2col+direct, megakernel + "
                  f"megakernel_xla bit-identical to the float-boundary "
                  f"forward on {PROBE_IMAGES} held-out images "
                  f"({', '.join(sorted(packs))})", flush=True)

        # (d) The sign-form checkpoint, loaded on the card and served.
        sign_path = work / "trained_sign.npz"
        save_binary_checkpoint(sign_path, res.params)
        loaded = load_binary_checkpoint(sign_path, device=dev)
        with torch.no_grad():
            before = bnn_eval_logits(res.params, probe)
            after = bnn_eval_logits(loaded, probe)
        if not torch.equal(before, after):
            fail("sign-form checkpoint: logits changed in the round trip "
                 f"({int((before != after).sum())} differ)")
        result["sign_checkpoint_bytes"] = sign_path.stat().st_size
        fused = pack_bnn_params_fused(loaded)
        mega = pack_bnn_params_megakernel(loaded)
        requests = random_requests(np.random.default_rng(8), count=12,
                                   max_images=8)
        served = {}
        for name, eng in (
                ("xnor/direct", ServingEngine(fused, engine="xnor",
                                              conv_impl="direct",
                                              max_wait_s=0.0)),
                ("megakernel", ContinuousServingEngine(
                    mega, engine="megakernel", max_wait_s=0.0))):
            eng.warmup()
            rids = []
            for imgs in requests:
                rids.append(eng.submit(imgs))
                eng.step()
            eng.drain()
            for i, (imgs, rid) in enumerate(zip(requests, rids)):
                got = eng.take(rid)
                if got is None or is_error(got):
                    fail(f"serve {name}: request {i} has no logits: {got}")
                with torch.no_grad():
                    want = bnn_eval_logits(
                        loaded, torch.from_numpy(imgs).to(dev)).cpu().numpy()
                if not np.array_equal(got, want):
                    fail(f"serve {name}: request {i} differs from the "
                         "float-boundary forward of its images alone (max "
                         f"abs {np.abs(got - want).max()})")
            eng.executors.release()
            served[name] = len(requests)
            print(f"  served {name} from the sign-form checkpoint "
                  f"({sign_path.stat().st_size / 1e6:.2f} MB): "
                  f"{len(requests)} requests ({sum(r.shape[0] for r in requests)} "
                  "images) equal to the float-boundary forward", flush=True)
        result["served"] = served
        result["launches"] = dict(ops.LAUNCHES)
        print(f"  launches of phase 8: {result['launches']}", flush=True)
        for name in ("fused_direct_conv", "fused_xnor_gemm", "xnor_gemm",
                     "megakernel_conv_stage", "megakernel_chain"):
            if not result["launches"][name]:
                fail(f"phase 8: {name} was not launched")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return result


# Phase 9: replicas of one card when it is alone; the heartbeat timeout on
# the phase's fake clock, and the host-clock reps of its dispatch times.
MESH_REPLICAS_ON_ONE_CARD = 4
HEARTBEAT_S = 10.0
MESH_TIME_REPS = 50


class FakeClock:
    """An engine clock that moves only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def mesh_phase(dev) -> dict:
    """Phase 9: the BNN served over a mesh of replicas on the trained
    checkpoint. The mesh is every visible card when there are at least
    two, else ``MESH_REPLICAS_ON_ONE_CARD`` replicas sharing the card, each
    with its own stream, graph pool and graphs.

    (a) ``ServingEngine(engine="xnor", conv_impl="direct", mesh=)``: its
    ladder is ``mesh_buckets(DEFAULT_BUCKETS, k)``, warmup builds one
    executor a rung, 12 requests of 1-8 images each equal, bit for bit,
    the single-device ``xla`` forward of its images alone on the card; the
    launch counts, 0 just before the engine is built, are k x the path's
    kernels for every forward of warmup (each rung's eager run before its
    capture and one replay) and every dispatched batch; no failover, no
    shrink. (b) The continuous ``megakernel`` engine on the same mesh with
    a ``device_loss`` of replica 1 at dispatch 2, on a fake clock: the
    batch in flight is re-dispatched on the survivors (k/2), every answer
    stays bit-identical, the snapshot reads one shrink and no failed
    request, the extents are multiples of the survivor count and traffic
    builds no executor; then replica 1 stops beating past
    ``HEARTBEAT_S`` and the next ``step()`` shrinks the mesh again; the
    launch counts match every forward on the mesh of its time. Counts of
    (a) and (b) are the path ``bnn_serve_mesh``. (c) Host-clock times of
    a batch-32 dispatch through the meshed xnor/direct executors (k
    graphs, launched then collected) beside the unmeshed one (one graph of
    32 rows), and of each shrink's re-warm: a record, not a claim (on one
    card the replicas share its SMs)."""
    from repro_torch.core.bnn import (load_binary_checkpoint,
                                      pack_bnn_params_fused,
                                      pack_bnn_params_megakernel)
    from repro_torch.distributed.fault_tolerance import serving_shrink_plan
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.launch.serve_bnn import random_requests
    from repro_torch.serve import (DEFAULT_BUCKETS, ContinuousServingEngine,
                                   ExecutorCache, FaultPlan, FaultSpec,
                                   ServingEngine, is_error, mesh_buckets)

    cards = torch.cuda.device_count()
    mesh = ServingMesh(tuple(torch.device("cuda", i) for i in range(cards))
                       if cards >= 2 else (dev,) * MESH_REPLICAS_ON_ONE_CARD)
    k = len(mesh)
    print(f"  mesh: {k} replicas on {len(set(mesh.devices))} card(s) "
          f"({', '.join(map(str, mesh.devices))})", flush=True)
    latent = load_binary_checkpoint(CKPT, device=dev)
    packed = pack_bnn_params_fused(latent)
    mega = pack_bnn_params_megakernel(latent)
    requests = random_requests(np.random.default_rng(9), count=12, max_images=8)
    wants = [wants_of(packed, r, dev) for r in requests]
    result = {"replicas": k, "cards": len(set(mesh.devices)),
              "requests": len(requests),
              "images": sum(r.shape[0] for r in requests)}

    def serve(eng, label: str, picked: range) -> None:
        rids = []
        for i in picked:
            rids.append(eng.submit(requests[i]))
            eng.step()
        eng.drain()
        for i, rid in zip(picked, rids):
            got = eng.take(rid)
            if got is None or is_error(got):
                fail(f"mesh {label}: request {i} has no logits: {got}")
            if not np.array_equal(got, wants[i]):
                fail(f"mesh {label}: request {i} differs from the "
                     "single-device xla forward (max abs "
                     f"{np.abs(got - wants[i]).max()})")

    def forwards_launch(path: str, forwards: int) -> dict:
        return {name: n * forwards
                for name, n in launches_per_forward(path).items()}

    # (a) The bucket engine. This path's counts: 0 just before its engine.
    ops.reset_launches()
    t0 = time.monotonic()
    eng = ServingEngine(packed, engine="xnor", conv_impl="direct",
                        max_wait_s=0.0, mesh=mesh)
    ladder = mesh_buckets(DEFAULT_BUCKETS, k)
    if eng.batcher.buckets != ladder:
        fail(f"mesh bucket ladder {eng.batcher.buckets}, expected {ladder}")
    if eng.warmup() != len(ladder):
        fail(f"mesh warmup built {eng.executors.size} executors for {ladder}")
    result["bucket_warmup_s"] = time.monotonic() - t0
    serve(eng, "xnor/direct", range(len(requests)))
    torch.cuda.synchronize()
    snap = eng.snapshot()
    forwards = k * (2 * len(ladder) + snap["batches"]["dispatched"])
    counts = dict(ops.LAUNCHES)
    if counts != forwards_launch("direct", forwards):
        fail(f"mesh xnor/direct: launches {counts} over {forwards} replica "
             f"forwards, expected {forwards_launch('direct', forwards)}")
    if (snap["degraded"] or snap["mesh"]["shrinks"]
            or snap["executors"]["compiles"] != len(ladder)):
        fail(f"mesh xnor/direct: failover, shrink or build under traffic: "
             f"{snap['dispatch']} {snap['mesh']} {snap['executors']}")
    eng.executors.release()
    result["bucket"] = {"ladder": list(ladder), "forwards": forwards,
                        "launches": counts,
                        "per_bucket": snap["batches"]["per_bucket"]}
    print(f"  mesh xnor/direct bucket engine: ladder {list(ladder)}, "
          f"{len(requests)} requests ({result['images']} images) "
          f"bit-identical to the single-device xla forward; {forwards} "
          f"replica forwards launched {counts}; warmup "
          f"{result['bucket_warmup_s']:.2f} s", flush=True)

    # (b) The continuous megakernel engine: a loss, then a silent replica.
    clk = FakeClock()
    eng = ContinuousServingEngine(
        mega, engine="megakernel", max_wait_s=0.0, mesh=mesh,
        heartbeat_timeout_s=HEARTBEAT_S, clock=clk,
        faults=FaultPlan([FaultSpec("device_loss", at=2, device=1)],
                         sleep=clk.advance))
    ladders = [(k, eng.extents)]
    eng.warmup()
    rewarm_s = []
    warmup = eng.warmup

    def timed_warmup() -> int:
        t = time.monotonic()
        built = warmup()
        torch.cuda.synchronize()
        rewarm_s.append(time.monotonic() - t)
        ladders.append((eng.executors.devices, eng.extents))
        return built

    eng.warmup = timed_warmup   # the shrink re-warms through this
    serve(eng, "megakernel, device loss", range(6))
    snap = eng.snapshot()
    survivors = serving_shrink_plan(k - 1)
    if (snap["mesh"] != {"shrinks": 1, "devices": survivors}
            or snap["requests"]["failed"] or not snap["degraded"]):
        fail(f"mesh device loss: snapshot mesh {snap['mesh']}, requests "
             f"{snap['requests']}, degraded {snap['degraded']}")
    if any(e % survivors for e in eng.extents):
        fail(f"mesh device loss: extents {eng.extents} on {survivors} devices")
    built = snap["executors"]["compiles"]
    serve(eng, "megakernel, shrunk", range(6, 9))
    if eng.snapshot()["executors"]["compiles"] != built:
        fail("mesh device loss: an executor was built under traffic")
    shrunk_until = eng.snapshot()["batches"]["dispatched"]
    if survivors > 1:
        clk.advance(HEARTBEAT_S / 2)
        for d in range(survivors):
            if d != 1:
                eng.beat(d)
        clk.advance(HEARTBEAT_S * 0.75)     # replica 1 silent past the timeout
    serve(eng, "megakernel, heartbeat", range(9, len(requests)))
    torch.cuda.synchronize()
    snap = eng.snapshot()
    last = serving_shrink_plan(survivors - 1) if survivors > 1 else survivors
    if (snap["mesh"]["devices"] != last or snap["requests"]["failed"]
            or snap["requests"]["completed"] != len(requests)):
        fail(f"mesh heartbeat: snapshot mesh {snap['mesh']}, requests "
             f"{snap['requests']}")
    # Every forward on the mesh of its time: k at warmup and for the two
    # dispatches before the loss (the lost one launched nothing), then the
    # survivors' re-warm and dispatches, then the last mesh's.
    (k0, e0), (k1, e1) = ladders[0], ladders[1]
    forwards = k0 * (2 * len(e0) + 2) + k1 * 2 * len(e1)
    if len(ladders) > 2:
        k2, e2 = ladders[2]
        forwards += (k1 * (shrunk_until - 2) + k2 * 2 * len(e2)
                     + k2 * (snap["batches"]["dispatched"] - shrunk_until))
    else:
        forwards += k1 * (snap["batches"]["dispatched"] - 2)
    mega_counts = {name: ops.LAUNCHES[name] - counts[name] for name in counts}
    if mega_counts != forwards_launch("megakernel", forwards):
        fail(f"mesh megakernel: launches {mega_counts} over {forwards} "
             f"replica forwards, expected "
             f"{forwards_launch('megakernel', forwards)}")
    eng.executors.release()
    result["launches"] = dict(ops.LAUNCHES)
    result["continuous"] = {
        "meshes": [n for n, _ in ladders],
        "extents": [list(e) for _, e in ladders], "forwards": forwards, "launches": mega_counts, "rewarm_s": rewarm_s,
        "snapshot_mesh": snap["mesh"], "per_bucket": snap["batches"]["per_bucket"]}
    print(f"  mesh megakernel continuous engine: meshes "
          f"{' -> '.join(str(n) for n, _ in ladders)} (device loss at "
          f"dispatch 2, then replica 1 silent past {HEARTBEAT_S:.0f} s), "
          f"extents {[list(e) for _, e in ladders]}; {len(requests)} requests "
          f"bit-identical, 0 failed; re-warm "
          f"{', '.join(f'{t:.3f}' for t in rewarm_s)} s (host clock); "
          f"{forwards} replica forwards launched {mega_counts}", flush=True)

    # (c) A batch-32 dispatch, meshed and not, on the host clock; beside
    # it the replays alone by CUDA events: the replicas' graphs on their
    # own streams, the same graphs one after another on one stream, and
    # the one graph of 32 rows.
    x = np.random.default_rng(10).normal(size=(BATCH, 32, 32, 3)).astype(
        np.float32)
    replays = {}
    for name, cache in (("mesh", ExecutorCache(packed, engine="xnor",
                                               conv_impl="direct", mesh=mesh)),
                        ("single", ExecutorCache(packed, engine="xnor",
                                                 conv_impl="direct"))):
        ex = cache.get(BATCH)
        got = ex(x)
        if not np.array_equal(got, ex(x)) or not np.array_equal(
                got, wants_of(packed, x, dev)):
            fail(f"mesh timing {name}: a dispatch differs from the forward")
        times = []
        for _ in range(MESH_TIME_REPS):
            t = time.perf_counter()
            ex(x)
            times.append(time.perf_counter() - t)
        result[f"dispatch_b32_{name}_ms"] = statistics.median(times) * 1e3
        graphs = [(e.graph, e.stream) for e in getattr(ex, "replicas", [ex])]
        replays[name] = replays_ms(dev, graphs)
        if name == "mesh":
            replays["mesh_one_stream"] = replays_ms(
                dev, [(g, None) for g, _ in graphs])
        cache.release()
    result["replay_b32_ms"] = replays
    print(f"  batch {BATCH} dispatch (host clock, copies in and out "
          f"included, median of {MESH_TIME_REPS}): {k} graphs of "
          f"{BATCH // k} rows launched then collected "
          f"{result['dispatch_b32_mesh_ms']:.3f} ms, one graph of {BATCH} "
          f"rows {result['dispatch_b32_single_ms']:.3f} ms; replays alone "
          f"(CUDA events): {k} graphs on their streams "
          f"{replays['mesh']:.3f} ms, on one stream "
          f"{replays['mesh_one_stream']:.3f} ms, one graph "
          f"{replays['single']:.3f} ms", flush=True)
    return result


# Phase 10: the data-parallel BNN on replicas (every card when there are at
# least 8, else 8 round-robin over the visible cards), the JAX benchmarks'
# gates (benchmarks/train_bench.py, benchmarks/train_chaos.py).
DP_REPLICAS = 8
DP_STEPS = 60
DP_TIMED_FROM = 10
DP_REPLAY_STEPS = 10
LOSS_DROP_GATE = 0.30
CHAOS_STEPS, CHAOS_EVERY = 24, 6
CHAOS_AT = {"preempt": 8, "torn_ckpt": 12, "nan_batch": 14, "device_loss": 20}
CHAOS_LOST_HOST = 5
STRAGGLER_HOST, STRAGGLER_STEPS, STRAGGLER_EVERY = 7, 8, 4
EF_RTOL = 1e-5


def dp_mesh():
    """Phase 10's mesh: every card when there are ``DP_REPLICAS`` or more
    (and they divide the batch), else ``DP_REPLICAS`` replicas spread
    round-robin over the cards."""
    from repro_torch.launch.mesh import ServingMesh

    cards = torch.cuda.device_count()
    k = cards if cards >= DP_REPLICAS and 64 % cards == 0 else DP_REPLICAS
    return ServingMesh(tuple(torch.device("cuda", i % cards) for i in range(k)))


def train_resilient_phase(dev) -> dict:
    """Phase 10: the BNN trained over a mesh of replicas, under chaos.

    (a) The data-parallel step (``make_dp_train_step``) at full width,
    batch 64: on one shard with ``"none"`` it must equal ``make_train_step``
    bit for bit; on the mesh, from one init, each compression runs
    ``DP_STEPS`` steps of the stateless stream (the cosine horizon is
    ``DP_STEPS``) and must pass ``benchmarks/train_bench.py``'s gates (the
    final-quarter mean loss ``LOSS_DROP_GATE`` below the first step's,
    relatively; each compressed run's final loss within ``max(2 base, base
    + 0.5)`` of the float32 run's); a second ``DP_REPLAY_STEPS``-step
    sign-SGD run must reproduce the first's params at that step bit for
    bit. Each compression's step ms (CUDA events), images/s and device
    busy share (``torch.profiler``). (b) ``benchmarks/train_chaos.py``'s
    full scenario through ``train_bnn_resilient`` on the mesh with
    sign-SGD (``control``, ``chaosA``: preemption, torn checkpoint, NaN
    batch; ``controlB``: a lost host 8 -> 4; ``chaosB``: all four) and its
    six gates, computed as that script computes them; then a straggler
    (host ``STRAGGLER_HOST`` at 10x from step 1 for 4 steps, patience 3)
    must be evicted, the mesh shrink to 4 and the run end finite.
    Checkpoints go under ``build/`` and are removed. (c) ``chaosB``'s
    params through ``pack_trained_params`` on 64 held-out images: every
    engine verified. The launch counts are 0 at the phase's start and read
    at its end: training launches none, the export each serving kernel
    (the path ``bnn_train_resilient``)."""
    import shutil

    from repro_torch import tree
    from repro_torch.core.bnn import (init_bnn_params, pack_trained_params,
                                      update_bn_stats)
    from repro_torch.data.pipeline import DataConfig, cifar_batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.train.bnn_trainer import (DP_COMPRESSIONS,
                                               BNNTrainerConfig, _BNNTask,
                                               bnn_clip_predicate,
                                               init_dp_error_feedback,
                                               make_dp_train_step)
    from repro_torch.train.resilience import (ResilienceConfig,
                                              TrainFaultPlan, TrainFaultSpec,
                                              train_bnn_resilient)
    from repro_torch.train.step import init_opt_state, make_train_step

    t_phase = time.monotonic()
    mesh = dp_mesh()
    k = len(mesh)
    cfg = BNNTrainerConfig(steps=DP_STEPS)
    task = _BNNTask(cfg.model_config())
    tcfg = cfg.train_config()
    data_cfg = DataConfig(seed=cfg.data_seed, global_batch=cfg.batch)
    feeds = [{key: cifar_batch_at(data_cfg, i)[key].to(dev)
              for key in ("images", "labels")} for i in range(DP_STEPS)]
    result = {"replicas": k, "cards": len(set(mesh.devices)),
              "batch": cfg.batch, "steps": DP_STEPS}
    print(f"  mesh: {k} replicas on {result['cards']} card(s), batch "
          f"{cfg.batch} ({cfg.batch // k} images a shard)", flush=True)
    # This phase's counts: 0 here, read at its end.
    ops.reset_launches()

    # (a) One shard is the single-device step.
    single = make_train_step(task, tcfg, clip_predicate=bnn_clip_predicate)
    one = make_dp_train_step(task, tcfg, ServingMesh((dev,)),
                             grad_compression="none",
                             clip_predicate=bnn_clip_predicate)
    params = init_bnn_params(cfg.seed, device=dev)
    a = (params, init_opt_state(params))
    b = (*a, init_dp_error_feedback(params, 1))
    for i, feed in enumerate(feeds[:3]):
        pa, oa, ma = single(*a, feed)
        pb, ob, eb, mb = one(*b, feed)
        differ = [path for (path, x), y in zip(
            tree.leaves_with_path((pa, oa, ma)), tree.leaves((pb, ob, mb)))
            if not torch.equal(x, y)]
        if differ:
            fail(f"DP step on one shard differs from the single-device step "
                 f"at step {i}: {differ[:5]}")
        a, b = (pa, oa), (pb, ob, eb)
    del a, b
    print("  make_dp_train_step on 1 shard, 'none': 3 steps bit-identical "
          "to make_train_step", flush=True)

    # (a) Each compression on the mesh, from one init.
    runs = {}
    replay_at = None
    for comp in DP_COMPRESSIONS:
        step = make_dp_train_step(task, tcfg, mesh, grad_compression=comp,
                                  clip_predicate=bnn_clip_predicate)
        params = init_bnn_params(cfg.seed, device=dev)
        state = [params, init_opt_state(params),
                 init_dp_error_feedback(params, k)]
        losses = []

        def run_steps(batch_feeds, state=state, step=step, losses=losses):
            for feed in batch_feeds:
                p, o, e, m = step(*state, feed)
                state[:] = [update_bn_stats(p, m.pop("bn_stats"),
                                            momentum=cfg.bn_momentum), o, e]
                losses.append(m["loss"])

        torch.cuda.synchronize()
        t0 = time.monotonic()
        run_steps(feeds[:DP_TIMED_FROM])
        if comp == "signsgd":
            replay_at = [x.clone() for x in tree.leaves(state[0])]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_steps(feeds[DP_TIMED_FROM:])
        end.record()
        end.synchronize()
        run_s = time.monotonic() - t0
        step_ms = start.elapsed_time(end) / (DP_STEPS - DP_TIMED_FROM)
        loss = torch.stack(losses).tolist()
        tail = float(np.mean(loss[-max(1, len(loss) // 4):]))
        drop = 1.0 - tail / loss[0]
        # The busy share over one more step (after the gated run).
        extra = feeds[:1]
        breakdown = device_breakdown(lambda: run_steps(extra), top=8)
        device_ms = (breakdown[-1][1] / len(extra)
                     if not isinstance(breakdown, str) else None)
        runs[comp] = {"first_loss": loss[0], "tail_mean_loss": tail,
                      "final_loss": loss[DP_STEPS - 1], "loss_drop": drop,
                      "run_s": run_s, "step_ms": step_ms,
                      "images_per_s": cfg.batch * 1e3 / step_ms,
                      "step_device_ms": device_ms,
                      "busy_share": (None if device_ms is None
                                     else device_ms / step_ms),
                      "breakdown": breakdown}
        print(f"  DP {comp:8s} {k} replicas: loss {loss[0]:.4f} -> final "
              f"quarter {tail:.4f} (drop {drop:.3f}), final "
              f"{runs[comp]['final_loss']:.4f}; step {step_ms:.3f} ms by CUDA "
              f"events over steps {DP_TIMED_FROM}-{DP_STEPS - 1}, "
              f"{runs[comp]['images_per_s']:.0f} images/s; device busy "
              + ("not measured" if device_ms is None else
                 f"{device_ms:.3f} ms a step, share "
                 f"{runs[comp]['busy_share']:.3f}")
              + f"; {DP_STEPS} steps in {run_s:.2f} s (host clock)",
              flush=True)
        if not isinstance(breakdown, str):
            for kname, ms, share in breakdown:
                print(f"    {ms:10.3f} ms {share:6.1%}  {kname}", flush=True)
        if not drop >= LOSS_DROP_GATE:
            fail(f"DP {comp}: final-quarter loss {tail} is not "
                 f"{LOSS_DROP_GATE:.0%} below the first {loss[0]}")
        del state[:]
    base = runs["none"]["final_loss"]
    for comp in ("int8", "signsgd"):
        if not runs[comp]["final_loss"] <= max(2.0 * base, base + 0.5):
            fail(f"DP {comp}: final loss {runs[comp]['final_loss']} does not "
                 f"track the float32 run's {base}")
    result["dp"] = runs
    print("  (PR 23's single-device step at batch 64: 47.6 ms)", flush=True)

    # (a) The sign-SGD run replays bit for bit.
    step = make_dp_train_step(task, tcfg, mesh, grad_compression="signsgd",
                              clip_predicate=bnn_clip_predicate)
    params = init_bnn_params(cfg.seed, device=dev)
    state = [params, init_opt_state(params), init_dp_error_feedback(params, k)]
    for feed in feeds[:DP_REPLAY_STEPS]:
        p, o, e, m = step(*state, feed)
        state = [update_bn_stats(p, m.pop("bn_stats"),
                                 momentum=cfg.bn_momentum), o, e]
    differ = sum(not torch.equal(x, y)
                 for x, y in zip(tree.leaves(state[0]), replay_at))
    if differ:
        fail(f"DP signsgd: a second {DP_REPLAY_STEPS}-step run differs from "
             f"the first in {differ} param leaves")
    result["signsgd_replay_leaves_equal"] = len(replay_at)
    print(f"  DP signsgd: a second {DP_REPLAY_STEPS}-step run bit-identical "
          f"({len(replay_at)} param leaves)", flush=True)
    del state, replay_at, feeds
    if any(ops.LAUNCHES.values()):
        fail(f"DP training launched kernels {dict(ops.LAUNCHES)}")

    # (b) The chaos scenario.
    work = OUT_DIR / "chip_smoke_resilient"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ccfg = BNNTrainerConfig(steps=CHAOS_STEPS, checkpoint_every=CHAOS_EVERY,
                            eval_batches=0)
    chaos_specs = [TrainFaultSpec("preempt", at=CHAOS_AT["preempt"]),
                   TrainFaultSpec("torn_ckpt", at=CHAOS_AT["torn_ckpt"],
                                  flavor="torn"),
                   TrainFaultSpec("nan_batch", at=CHAOS_AT["nan_batch"])]
    loss_spec = TrainFaultSpec("device_loss", at=CHAOS_AT["device_loss"],
                               host=CHAOS_LOST_HOST)
    plans = {"control": None, "chaosA": TrainFaultPlan(chaos_specs),
             "controlB": TrainFaultPlan([loss_spec]),
             "chaosB": TrainFaultPlan(chaos_specs + [loss_spec])}
    chaos = {}
    try:
        for name, plan in plans.items():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = train_bnn_resilient(
                dataclasses.replace(ccfg, checkpoint_dir=str(work / name)),
                mesh=mesh, faults=plan, grad_compression="signsgd")
            torch.cuda.synchronize()
            fired = len(plan.fired) if plan is not None else 0
            chaos[name] = {"result": res, "fired": fired,
                           "seconds": time.monotonic() - t0}
            shutil.rmtree(work / name, ignore_errors=True)
            print(f"  {name:8s} faults={fired} recomputed="
                  f"{res.recomputed_steps} n_dev={res.n_devices} events "
                  f"{[e['kind'] for e in res.events]} final loss "
                  f"{res.history['loss'][-1]:.4f} "
                  f"({chaos[name]['seconds']:.2f} s)", flush=True)

        def trees_equal(x, y):
            lx, ly = tree.leaves(x), tree.leaves(y)
            return len(lx) == len(ly) and all(
                torch.equal(u, v) for u, v in zip(lx, ly))

        def finite(x):
            return all(bool(torch.isfinite(v).all()) for v in tree.leaves(x))

        def resumes_ok(c, ctrl):
            fps = ctrl["result"].fingerprints
            return all(p["step"] in fps and p["params_sha"] == fps[p["step"]]
                       for p in c["result"].restore_points)

        nan_steps = set(plans["chaosA"].steps_of("nan_batch"))
        caught = {e["step"] for name in ("chaosA", "chaosB")
                  for e in chaos[name]["result"].events
                  if e["kind"] == "sentinel_nan"}
        folds = [e for name in ("controlB", "chaosB")
                 for e in chaos[name]["result"].events
                 if e["kind"] == "ef_folded"]
        gates = {
            "zero_runs_lost": all(
                len(c["result"].history["loss"]) == CHAOS_STEPS
                and finite(c["result"].params) for c in chaos.values()),
            "bit_identical_A": trees_equal(chaos["control"]["result"].params,
                                           chaos["chaosA"]["result"].params),
            "bit_identical_B": trees_equal(chaos["controlB"]["result"].params,
                                           chaos["chaosB"]["result"].params),
            "sentinel_catches_all_nan": nan_steps <= caught,
            "ef_mass_conserved": (
                len(folds) == 2
                and all(f["max_rel_delta"] <= EF_RTOL for f in folds)
                and all(f["n_old"] == k and f["n_new"] == k // 2
                        for f in folds)),
            "bounded_recompute": all(
                c["result"].recomputed_steps <= CHAOS_EVERY * max(c["fired"], 1)
                for c in chaos.values()),
            "resume_points_match": (resumes_ok(chaos["chaosA"], chaos["control"])
                                    and resumes_ok(chaos["chaosB"],
                                                   chaos["controlB"])),
        }
        print("  chaos gates: " + ", ".join(
            f"{g} {'PASS' if ok else 'FAIL'}" for g, ok in gates.items()),
            flush=True)
        if not all(gates.values()):
            fail(f"chaos gates: {gates}")

        # The straggler.
        plan = TrainFaultPlan([TrainFaultSpec("straggler", at=1, count=4,
                                              host=STRAGGLER_HOST)])
        t0 = time.monotonic()
        strag = train_bnn_resilient(
            BNNTrainerConfig(steps=STRAGGLER_STEPS,
                             checkpoint_every=STRAGGLER_EVERY, eval_batches=0,
                             checkpoint_dir=str(work / "straggler")),
            mesh=mesh, faults=plan, grad_compression="signsgd",
            resilience=ResilienceConfig(straggler_patience=3))
        strag_s = time.monotonic() - t0
        evicted = [e for e in strag.events if e["kind"] == "straggler_evicted"]
        if (not evicted or evicted[0]["hosts"] != [STRAGGLER_HOST]
                or strag.n_devices != k // 2 or not finite(strag.params)
                or len(strag.history["loss"]) != STRAGGLER_STEPS):
            fail(f"straggler: events {strag.events}, n_devices "
                 f"{strag.n_devices}")
        print(f"  straggler host {STRAGGLER_HOST}: evicted at step "
              f"{evicted[0]['step']}, mesh {k} -> {strag.n_devices}, events "
              f"{[e['kind'] for e in strag.events]}, finite "
              f"({strag_s:.2f} s)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if any(ops.LAUNCHES.values()):
        fail(f"resilient training launched kernels {dict(ops.LAUNCHES)}")
    result["chaos"] = {
        "config": {"steps": CHAOS_STEPS, "batch": ccfg.batch,
                   "checkpoint_every": CHAOS_EVERY, "n_devices": k,
                   "grad_compression": "signsgd", "ef_rtol": EF_RTOL,
                   "fault_plan": {**CHAOS_AT,
                                  "device_loss_host": CHAOS_LOST_HOST}},
        "runs": {name: {
            "faults_fired": c["fired"], "seconds": c["seconds"],
            "events": [e["kind"] for e in c["result"].events],
            "recomputed_steps": c["result"].recomputed_steps,
            "restore_points": c["result"].restore_points,
            "device_trajectory": c["result"].device_trajectory,
            "final_n_devices": c["result"].n_devices,
            "final_loss": c["result"].history["loss"][-1]}
            for name, c in chaos.items()},
        "ef_folds": folds, "gates": gates,
        "straggler": {"events": strag.events, "n_devices": strag.n_devices,
                      "seconds": strag_s}}

    # (c) chaosB's params, exported under the probe.
    probe = cifar_batch_at(DataConfig(seed=cfg.data_seed,
                                      global_batch=PROBE_IMAGES),
                           CHAOS_STEPS)["images"].to(dev)
    t0 = time.monotonic()
    try:
        packs = pack_trained_params(chaos["chaosB"]["result"].params,
                                    probe_images=probe)
    except ValueError as err:
        fail(f"export of chaosB: {err}")
    result["export_s"] = time.monotonic() - t0
    print(f"  export of chaosB: every engine bit-identical to the "
          f"float-boundary forward on {PROBE_IMAGES} held-out images "
          f"({', '.join(sorted(packs))}, {result['export_s']:.2f} s)",
          flush=True)
    result["launches"] = dict(ops.LAUNCHES)
    for name in ("fused_direct_conv", "fused_xnor_gemm", "xnor_gemm",
                 "megakernel_conv_stage", "megakernel_chain"):
        if not result["launches"][name]:
            fail(f"phase 10: {name} was not launched")
    result["phase_s"] = time.monotonic() - t_phase
    print(f"  launches of phase 10: {result['launches']}; phase "
          f"{result['phase_s']:.1f} s", flush=True)
    return result


def wants_of(packed: dict, x: np.ndarray, dev) -> np.ndarray:
    """The single-device ``xla`` forward of ``x`` on the card."""
    from repro_torch.core.bnn import bnn_apply_fused

    with torch.inference_mode():
        return bnn_apply_fused(packed, torch.from_numpy(x).to(dev),
                               engine="xla", conv_impl="direct").cpu().numpy()


def replays_ms(dev, graphs: list, iters: int = 20, reps: int = 5) -> float:
    """Device time of one round of ``graphs`` (``[(graph, stream or
    None)]``): each replayed ``iters`` times on its stream (the current
    one for None), every stream starting after one event and the current
    stream waiting for all before the next, by CUDA events (median of
    ``reps``, divided by ``iters``)."""
    cur = torch.cuda.current_stream(dev)
    streams = [stream or cur for _, stream in graphs]
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(cur)
        for stream in streams:
            stream.wait_stream(cur)
        for (graph, _), stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                for _ in range(iters):
                    graph.replay()
        for stream in streams:
            cur.wait_stream(stream)
        end.record(cur)
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times[1:])


# ------------------------- phase 11: the LM trainer -------------------------

# (label, B, C, di, ds, sequence) of the scan's backward: jamba's chunk
# (its time makes the kernels-line total; the operands as the prefill's,
# chunk views of a longer sequence), a ragged case, a state width past 16
# (the kernel's 32-state build), and timed beside them, not summed, the
# jamba prefill's batch of 4 and the smoke jamba's training shape (2
# launches a step in lm_train_phase).
SCAN_BWD_CASES = [("jamba chunk", 1, 256, 16384, 16, 512),
                  ("ragged", 3, 37, 1000, 13, 37),
                  ("ds 24", 2, 64, 300, 24, 64),
                  ("jamba prefill batch", 4, 256, 16384, 16, 512),
                  ("smoke jamba step", 8, 64, 256, 8, 64)]
# Backward kernels against their twins on the same saved tensors: each
# gradient within rtol of itself plus atol of its largest magnitude
# (a sum over thousands of terms in another order lands where
# cancellation leaves a small total). Set from the readings on an H100
# (at most 3.5e-6 of the largest magnitude: flash's float32 dk; the scan
# and the mLSTM at most 1e-6), with 5x room.
BWD_F32_TOL = dict(rtol=1e-4, atol=2e-5)
# Bf16 flash backward: the kernel and the twin round p and dS to bf16 at
# the same points, but the float32 sums before them run in other orders,
# so a p or dS can round to the neighbouring bf16 value, and the outputs
# round to bf16 at the end: each gradient within BWD_BF16_ULPS bf16 ulps
# of its largest magnitude. Readings on an H100: at most 2.1e-3 of the
# largest magnitude (dk at smollm's shape), about half such an ulp.
BWD_BF16_ULPS = 2.0
# Per-leaf relative L2 error of the first step's gradients, kernels
# against twins, both forward and backward, over every parameter leaf.
# Bf16: smollm-360m read 6.8e-3 at most (median 2.6e-3) on an H100;
# float32 activations (xlstm, see LM_TRAIN_CASES): set from its reading.
LM_GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
# The LM training runs: (arch, batch, seq, steps, layers or None for the
# published depth, the activations' dtype of the first-step gradient
# check or None for the config's, whether a step is profiled). xlstm's
# dtype is float32: in bf16 its logits are not reproducible under
# float32-ulp changes of one mLSTM output (phase 7), so no
# kernel-vs-twin gradient gate holds there. Its step is not profiled:
# on an H100 the profiler took ~90 s over the sLSTM loop's ~10^5
# launches (a profiled step: 105.8 s on the host clock, 15.2 s of it the
# step itself).
LM_TRAIN_CASES = [("smollm-360m", 4, 4096, 3, None, None, True),
                  ("xlstm-1.3b", 2, 4096, 2, 8, torch.float32, False)]
# quickstart.py's settings, through the launcher, for the smoke families
SMOKE_TRAIN = dict(steps=60, batch=8, seq=64, lr=1e-3)
SMOKE_ARCHS = ("smollm-360m", "xlstm-1.3b", "jamba-1.5-large-398b")


def grad_error(kernel: str, label: str, names, got, want, dtype) -> dict:
    """Each gradient against the twin's: float32 within ``BWD_F32_TOL``
    (rtol of itself plus atol of the tensor's largest magnitude), bf16
    within ``BWD_BF16_ULPS`` bf16 ulps of the tensor's largest magnitude.
    Returns the max abs error, and per tensor its error over its largest
    magnitude (``rel``)."""
    out = {"max_abs_err": 0.0}
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.isfinite(g).all():
            fail(f"{kernel} {label}: d{name} {tuple(g.shape)}/{g.dtype} vs twin "
                 f"{tuple(w.shape)}/{w.dtype}, finite={bool(torch.isfinite(g).all())}")
        if not g.numel():
            continue
        gf, wf = g.float(), w.float()
        diff = (gf - wf).abs()
        scale = float(wf.abs().max()) or 1.0
        out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
        out[f"{name}_rel"] = float(diff.max()) / scale
        if dtype == torch.bfloat16:
            limit = BWD_BF16_ULPS * float(bf16_ulp(torch.tensor(scale)))
            bad = int((diff > limit).sum())
            what = f"{BWD_BF16_ULPS:g} bf16 ulps of its largest magnitude"
        else:
            limit = BWD_F32_TOL["rtol"] * wf.abs() + BWD_F32_TOL["atol"] * scale
            bad = int((diff > limit).sum())
            what = (f"rtol {BWD_F32_TOL['rtol']:g} of itself plus atol "
                    f"{BWD_F32_TOL['atol']:g} of its largest magnitude")
        if bad:
            fail(f"{kernel} {label}: {bad} of d{name} outside {what} of the plain "
                 f"twin (max abs err {float(diff.max()):.3g}, largest {scale:.3g})")
    return out


def kernel_split(run, top: int):
    """``device_breakdown`` of one call, printed kernel by kernel; profiled
    again once if the profiler saw no kernel."""
    split = device_breakdown(run, top=top)
    if isinstance(split, list) and len(split) == 1:
        split = device_breakdown(run, top=top)
    if isinstance(split, list) and len(split) == 1:
        split = "not measured (the profiler saw no kernel)"
    print("    its kernels: " + (split if isinstance(split, str) else ", ".join(
        f"{n.split('(')[0].split('<')[0].split()[-1]} {ms:.3f} ms"
        for n, ms, _ in split[:-1])), flush=True)
    return split


def lm_bwd_kernel_phase(dev, totals: dict, rows: list) -> None:
    """The three backward kernels at their training shapes, each held to
    its twin run on the card on the same saved tensors (the forward
    kernel's output and what it keeps: flash attention's row log-sum-exp,
    the mLSTM's chunk states), checked to repeat bit for bit over two
    calls, and timed: flash attention at FLASH_BWD_CASES (bf16 at
    smollm-360m's training shape makes the total) with SDPA's backward on
    the same tensors as its yardstick, the scan at
    SCAN_BWD_CASES, the mLSTM at MLSTM_CASES with random final-state
    gradients. Bounds: flash 5 BH S^2 Dh operations (2.5x the forward's)
    at the bf16 tensor-core rate (float32: the CUDA cores'), against its
    operands and gradients; the scan B C di ds exps at the MUFU rate
    against its operands and gradients; the mLSTM L (L + 1) (3 dk + 2
    dv) + 8 L dk dv per (bh, chunk) (five [L, L] products over the causal
    half, four [L, d] x [d, d] ones) at the float32 rate. One scan
    backward call's peak memory (its outputs and scratch) is printed at
    every SCAN_BWD_CASES shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.roofline import op_cost

    gen = torch.Generator(device=dev).manual_seed(25)
    F = torch.nn.functional
    for label, bh, s, dh, dtype in FLASH_BWD_CASES:
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        do = torch.randn((bh, s, dh), generator=gen, device=dev).to(dtype)
        o, lse = ops._flash_forward(q, k, v, True)
        run = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731,B023
        twin = lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do)  # noqa: E731,B023
        want = twin()
        e = grad_error("flash_attention_bwd", label, "qkv", run(), want, dtype)
        e["repeats_exactly"] = repeats_exactly("flash_attention_bwd", label, run)
        del want
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        do4 = do[None]
        sdpa = lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)  # noqa: E731,B023
        sdpa_ms = time_ms(sdpa, iters=5)
        nbytes = (8 * bh * s * dh) * q.element_size() + 4 * bh * s
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        summed = label == "smollm layer"
        row = record(totals["flash_attention_bwd"], "flash_attention_bwd",
                     f"{label} [{bh},{s},{dh}] {str(dtype)[6:]}", e["max_abs_err"],
                     run, twin, None, nbytes,
                     op_cost.flash_flops(bh, s, s, dh, backward=True), summed=summed,
                     check=("max |err| / max |grad|: " + ", ".join(
                         f"d{n} {e[n + '_rel']:.2g}" for n in "qkv")
                         + ", two calls bit-identical"), rate=rate)
        row.update(e, library_ms=sdpa_ms)
        if summed:
            totals["flash_attention_bwd"]["library_ms"] = sdpa_ms
            row["breakdown"] = kernel_split(run, top=4)
        print(f"    SDPA backward (library yardstick) {sdpa_ms:.4f} ms", flush=True)
        rows.append(row)
        del q4, k4, v4, out4
    names = ("dt", "xh", "B", "C", "A", "h0")
    for label, b, c, di, ds, seq in SCAN_BWD_CASES:
        args = scan_operands(gen, b, c, di, ds, seq, dev)
        dy = torch.randn((b, c, di), generator=gen, device=dev)
        dh_last = torch.randn((b, di, ds), generator=gen, device=dev)
        run = lambda: ops.ssm_scan_chunk_bwd(*args, dy, dh_last)  # noqa: E731,B023
        twin = lambda: ref.ssm_scan_chunk_bwd_ref(*args, dy, dh_last)  # noqa: E731,B023
        want = twin()
        e = grad_error("ssm_scan_chunk_bwd", label, names, run(), want, torch.float32)
        e["repeats_exactly"] = repeats_exactly("ssm_scan_chunk_bwd", label, run)
        e["peak_bytes"] = call_peak_bytes(dev, run)
        del want
        print(f"    {label}: one call's peak memory {e['peak_bytes'] / 1e6:.1f} MB",
              flush=True)
        nbytes = (5 * b * c * di + 4 * b * c * ds + 2 * di * ds + 4 * b * di * ds) * 4
        row = record(totals["ssm_scan_chunk_bwd"], "ssm_scan_chunk_bwd",
                     f"{label} [{b},{c},{di},{ds}]", e["max_abs_err"], run, twin, None,
                     nbytes, op_cost.scan_flops(b, c, di, ds),
                     summed=label == "jamba chunk",
                     check=("max |err| / max |grad|: " + ", ".join(
                         f"d{n} {e[n + '_rel']:.2g}" for n in names)
                         + ", two calls bit-identical"))
        row.update(e)
        if label == "jamba chunk":
            row["breakdown"] = kernel_split(run, top=3)
        rows.append(row)
        del args, dy, dh_last
        torch.cuda.empty_cache()
    for label, bh, s, dk, dv, chunk in MLSTM_CASES:
        q = torch.randn((bh, s, dk), generator=gen, device=dev) * dk ** -0.5
        k = torch.randn((bh, s, dk), generator=gen, device=dev)
        v = torch.randn((bh, s, dv), generator=gen, device=dev)
        logi = torch.randn((bh, s), generator=gen, device=dev)
        logf = F.logsigmoid(torch.randn((bh, s), generator=gen, device=dev) + 2)
        y, _, _, _, states, nstates = ops._mlstm_forward(q, k, v, logi, logf, chunk)
        dy = torch.randn((bh, s, dv), generator=gen, device=dev)
        dC = torch.randn((bh, dk, dv), generator=gen, device=dev) * 1e-2
        dn = torch.randn((bh, 1, dk), generator=gen, device=dev) * 1e-2
        args = (q, k, v, logi, logf, y, states, nstates, dy, dC, dn)
        run = lambda: ops.mlstm_chunked_bwd(*args, chunk=chunk)  # noqa: E731,B023
        twin = lambda: ref.mlstm_chunked_bwd_ref(*args, chunk=chunk)  # noqa: E731,B023
        names = ("q", "k", "v", "logi", "logf")
        want = twin()
        e = grad_error("mlstm_chunked_bwd", label, names, run(), want, torch.float32)
        e["repeats_exactly"] = repeats_exactly("mlstm_chunked_bwd", label, run)
        del want
        ln = min(chunk, s)
        ops_n = op_cost.mlstm_flops(bh, s, dk, dv, chunk, backward=True)
        nbytes = 4 * (bh * s * (4 * dk + 6 * dv + 4) + states.numel() + nstates.numel()
                      + bh * (dk * dv + dk))
        row = record(totals["mlstm_chunked_bwd"], "mlstm_chunked_bwd",
                     f"{label} [{bh},{s},{dk},{dv}] L{ln}", e["max_abs_err"], run, twin,
                     None, nbytes, ops_n, summed=label == "xlstm layer",
                     check=("max |err| / max |grad|: " + ", ".join(
                         f"d{n} {e[n + '_rel']:.2g}" for n in names)
                         + ", two calls bit-identical"))
        row.update(e)
        if label == "xlstm layer":
            row["breakdown"] = kernel_split(run, top=8)
        rows.append(row)
        del args, states, nstates
        torch.cuda.empty_cache()


@contextlib.contextmanager
def twin_grads_in_place():
    """Within the block the three LM kernels run their plain twins forward
    and backward (flash with the kernel's KV tile), through the same
    ``autograd.Function``s."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    names = ("_flash_forward", "flash_attention_bwd", "_ssm_forward",
             "ssm_scan_chunk_bwd", "_mlstm_forward", "mlstm_chunked_bwd")
    saved = {n: getattr(ops, n) for n in names}
    ops._flash_forward = lambda q, k, v, causal: ref.flash_attention_ref(
        q, k, v, causal=causal, block_kv=ops.FLASH_TILE, return_lse=True)
    ops.flash_attention_bwd = ref.flash_attention_bwd_ref
    ops._ssm_forward = ref.ssm_scan_chunk_ref
    ops.ssm_scan_chunk_bwd = ref.ssm_scan_chunk_bwd_ref
    ops._mlstm_forward = lambda q, k, v, logi, logf, chunk: ref.mlstm_chunked_ref(
        q, k, v, logi, logf, chunk=chunk, return_states=True)
    ops.mlstm_chunked_bwd = ref.mlstm_chunked_bwd_ref
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)


def _leaf_rel_l2(got, want) -> dict:
    """Per-leaf relative L2 error ``|g - w| / |w|`` over matching trees."""
    from repro_torch import tree

    out = {}
    for (path, g), w in zip(tree.leaves_with_path(got), tree.leaves(want)):
        den = float(torch.linalg.vector_norm(w.float()))
        num = float(torch.linalg.vector_norm((g - w).float()))
        out["/".join(str(p) for p in path)] = num / den if den else num
    return out


def lm_train_run(dev, arch: str, batch: int, seq: int, steps: int,
                 layers: int | None, grad_dtype=None, profile: bool = True) -> dict:
    """One LM family trained at full width through ``launch.train.train``
    (``smoke=False``, ``train_policy()``, ``layers`` cutting the depth
    where given; a config fed by embeddings gets the launcher's
    ``stub_embeddings``): the first step's loss and gradients against the
    same step with the twins in place (forward and backward; activations
    in ``grad_dtype`` where given), per-leaf relative L2 within
    ``LM_GRAD_TOL``; the launch counts of every step (encdec: the
    decoder's self-attention only, the encoder's and the cross-attention
    take the chunked path); a finite loss at every step; ms a step by
    CUDA events, tokens/s, peak memory, and, with ``profile``, a profile
    of one step with its busy share."""
    from repro_torch.configs.base import get_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model_factory import build_model
    from repro_torch.models.transformer import num_periods, period_spec
    from repro_torch.train.step import _grads_of

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    mixer = {"attn": "flash_attention", "mlstm": "mlstm_chunked"}
    per_period = {}
    for kind in period_spec(cfg):
        if kind.mixer in mixer:
            per_period[mixer[kind.mixer]] = per_period.get(mixer[kind.mixer], 0) + 1
    # encdec: one flash call a decoder layer (a one-layer "period")
    periods = cfg.num_layers if cfg.family == "encdec" else num_periods(cfg)
    # remat: each period's forward runs twice, its backward once
    want = {name: 0 for name in ops.LAUNCHES}
    for name, n in per_period.items():
        want[name] = 2 * n * periods
        want[name + "_bwd"] = n * periods
    res = {"layers": cfg.num_layers, "batch": batch, "seq": seq}

    # the first step's gradients, kernels and twins, on train()'s params
    # and first batch (its seed 0)
    torch.cuda.empty_cache()
    model = build_model(cfg if grad_dtype is None else dataclasses.replace(
        cfg, dtype=grad_dtype), train_policy())
    params = model.init(torch.Generator(dev).manual_seed(0))
    b0 = next(synthetic_lm_batches(DataConfig(seed=0, global_batch=batch,
                                              seq_len=seq, vocab_size=cfg.vocab_size)))
    b0 = {"tokens": b0["tokens"].to(dev), "labels": b0["labels"].to(dev),
          **({"input_embeds": launch_train.stub_embeddings(
              b0["tokens"], cfg.d_model).to(dev)}
             if cfg.input_kind == "embeddings" else {})}
    ops.reset_launches()
    loss_k, _, grads_k = _grads_of(model, params, b0)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    if counts != want:
        fail(f"{arch} training step: launches {counts}, expected {want}")
    with twin_grads_in_place():
        loss_t, _, grads_t = _grads_of(model, params, b0)
    rel = _leaf_rel_l2(grads_k, grads_t)
    del grads_k, grads_t, params
    torch.cuda.empty_cache()
    dname = str(model.cfg.dtype)[6:]
    worst = max(rel, key=rel.get)
    res.update(loss_kernels=float(loss_k), loss_twins=float(loss_t),
               grad_rel_l2_max=rel[worst], grad_rel_l2_worst_leaf=worst,
               grad_rel_l2_median=statistics.median(rel.values()),
               launches_per_step={k: v for k, v in counts.items() if v})
    print(f"  {arch} first step: loss {float(loss_k):.5f} (twins {float(loss_t):.5f}), "
          f"gradients per-leaf rel L2 max {rel[worst]:.3g} ({worst}), median "
          f"{res['grad_rel_l2_median']:.3g} ({dname} activations); launches "
          f"{res['launches_per_step']}",
          flush=True)
    if not abs(float(loss_k) - float(loss_t)) <= LM_LOSS_TOL:
        fail(f"{arch} first step: loss {float(loss_k)} vs twins {float(loss_t)}")
    if rel[worst] > LM_GRAD_TOL[dname]:
        fail(f"{arch} first step: gradient {worst} rel L2 {rel[worst]:.3g} > "
             f"{LM_GRAD_TOL[dname]} of the twins'")

    # the steps through the launcher, each timed and counted
    step_ms, step_counts, profiled = [], [], {}
    made = launch_train.make_train_step

    def timed_step_factory(model_, tcfg):
        inner = made(model_, tcfg)

        def step(p, o, bt):
            if profile and len(step_ms) == steps - 1 and not profiled:
                # the last step once more on its inputs, profiled, before
                # it runs: its outputs are dropped, so the card never holds
                # a third copy of the params and the optimizer state
                t0 = time.monotonic()
                profiled["breakdown"] = device_breakdown(
                    lambda: inner(p, o, bt), top=16, warm=False)
                profiled["seconds"] = time.monotonic() - t0
            ops.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(p, o, bt)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            step_counts.append(dict(ops.LAUNCHES))
            return out

        return step

    launch_train.make_train_step = timed_step_factory
    get = launch_train.get_config
    launch_train.get_config = lambda name: cfg if name == arch else get(name)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        out = launch_train.train(arch, smoke=False, steps=steps, batch=batch,
                                 seq=seq, lr=3e-4, log_every=1, device=dev)
    finally:
        launch_train.make_train_step, launch_train.get_config = made, get
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    del out
    torch.cuda.empty_cache()
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"{arch} training: losses {losses}")
    for i, c in enumerate(step_counts):
        if c != want:
            fail(f"{arch} training step {i}: launches {c}, expected {want}")
    timed = step_ms[1:] or step_ms
    ms = statistics.median(timed)
    bd = profiled.get("breakdown", "not measured" if profile else "not profiled")
    busy = (bd[-1][1] / ms) if isinstance(bd, list) else None
    # the path's launches: the first step's gradients and every step
    res["launches"] = {name: counts[name] + sum(c[name] for c in step_counts)
                       for name in counts}
    res.update(losses=losses, step_ms=step_ms, ms_per_step=ms,
               tokens_per_s=batch * seq / (ms / 1e3), breakdown=bd, busy_share=busy)
    print(f"  {arch} ({cfg.num_layers} layers, batch {batch} x {seq}): losses "
          f"{[round(x, 4) for x in losses]}, {ms:.1f} ms a step (steps "
          f"{[round(x, 1) for x in step_ms]}), {res['tokens_per_s']:.0f} tokens/s, "
          f"peak memory {res['max_memory_allocated'] / 2**30:.2f} GiB, busy "
          + (bd if isinstance(bd, str) else f"{busy:.2f}"), flush=True)
    if isinstance(bd, list):
        res["profile_s"] = profiled["seconds"]
        print(f"    step profile ({profiled['seconds']:.1f} s to take): " + ", ".join(
            f"{n.split('(')[0][:40]} {t:.1f} ms" for n, t, _ in bd[:-1]), flush=True)
    return res


def smoke_runs(dev, archs, total: dict) -> dict:
    """Each smoke config of ``archs`` trained through the launcher with
    ``quickstart.py``'s settings (``SMOKE_TRAIN``); each must learn (the
    mean of the last 5 losses below the first 5's). Its launches are
    added to ``total``."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    smoke = {}
    for arch in archs:
        ops.reset_launches()
        out = train(arch, smoke=True, log_every=SMOKE_TRAIN["steps"], device=dev,
                    **SMOKE_TRAIN)
        losses = out["losses"]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        for name, n in counts.items():
            total[name] += n
        smoke[arch] = {"first5": first, "last5": last, "launches": counts}
        print(f"  smoke {arch}: loss {first:.4f} -> {last:.4f} over "
              f"{SMOKE_TRAIN['steps']} steps; launches {counts}", flush=True)
        if not (np.isfinite(losses).all() and last < first):
            fail(f"smoke {arch} did not learn: {first} -> {last}")
    return smoke


def lm_train_phase(dev, cases=LM_TRAIN_CASES) -> dict:
    """Phase 11: the LM trainer on the card (after the backward kernels'
    checks in ``lm_bwd_kernel_phase``). Each of ``cases`` through
    ``lm_train_run``; then the three smoke families through the launcher
    with ``quickstart.py``'s settings (``SMOKE_TRAIN``), each of which
    must learn (the mean of the last 5 losses below the first 5's; the
    jamba run launches the scan's backward), and the resume of
    ``tests/test_launch.py``: 12 steps with checkpoints every 5, then a
    run to 14 that resumes from step 10 and yields 4 losses. Launch
    counts of the whole phase are the ``lm_train`` path's."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    t0 = time.monotonic()
    res, total = {}, {name: 0 for name in ops.LAUNCHES}
    for arch, batch, seq, steps, layers, grad_dtype, profile in cases:
        ops.reset_launches()
        res[arch] = lm_train_run(dev, arch, batch, seq, steps, layers, grad_dtype,
                                 profile)
        for name, n in res[arch]["launches"].items():
            total[name] += n
    smoke = smoke_runs(dev, SMOKE_ARCHS, total)
    if not smoke["jamba-1.5-large-398b"]["launches"].get("ssm_scan_chunk_bwd"):
        fail("the smoke jamba run launched no ssm_scan_chunk_bwd")
    ckpt = OUT_DIR / "chip_smoke_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ops.reset_launches()
    kw = dict(smoke=True, batch=4, seq=32, lr=1e-3, ckpt_dir=str(ckpt),
              ckpt_every=5, log_every=100, device=dev)
    first_run = train("smollm-360m", steps=12, **kw)["losses"]
    resumed = train("smollm-360m", steps=14, **kw)["losses"]
    shutil.rmtree(ckpt, ignore_errors=True)
    for name, n in ops.LAUNCHES.items():
        total[name] += n
    if len(first_run) != 12 or len(resumed) != 4 or not np.isfinite(
            first_run + resumed).all():
        fail(f"resume: {len(first_run)} then {len(resumed)} losses, expected 12 then 4")
    res.update(smoke=smoke, resume={"first": first_run, "resumed": resumed},
               launches=total, seconds=time.monotonic() - t0)
    print(f"  resume: 12 steps, then {len(resumed)} from step 10; phase 11 "
          f"{res['seconds']:.1f} s", flush=True)
    return res


# ------------------- phase 12: the remaining LM families --------------------

# (arch, layers served or None for all of them): every width the published
# one; depth cut only for time (PERF.md §4, ``reduced``).
FAMILY_SERVE = [("qwen2.5-3b", None), ("qwen2.5-32b", 8),
                ("mistral-large-123b", 8), ("moonshot-v1-16b-a3b", 8),
                ("arctic-480b", 2), ("pixtral-12b", 8),
                ("seamless-m4t-large-v2", None)]
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 4, 512, 8
# Decode against prefill in float32 activations, batch 1, a 64-token
# prompt, the same packed params: the JAX package's own tolerance for it
# (tests/test_arch_smoke.py::test_decode_matches_parallel_forward),
# stated before the first run. MoE configs run at capacity_factor 16, as
# that test does, so that no token is dropped in either.
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
DECODE_PROMPT = 64
# (arch, batch, seq, steps, layers or None for all, profiled): train_4k's
# sequence, its batch of 256 cut to 2; pixtral-12b cut to 2 of its 40
# layers (its 12.4 G float32 params with AdamW's state take ~200 GB).
# seamless's step is not profiled: ~10^5 launches a step cost the
# profiler ~49 s on the card (ROADMAP A7e), time phase 18 takes.
FAMILY_TRAIN = [("seamless-m4t-large-v2", 2, 4096, 3, None, False),
                ("pixtral-12b", 2, 4096, 2, 2, True)]
FAMILY_SMOKE = ("qwen2.5-3b", "qwen2.5-32b", "mistral-large-123b",
                "moonshot-v1-16b-a3b", "arctic-480b", "pixtral-12b",
                "seamless-m4t-large-v2")
# the config whose serving is profiled: the most weights (2 x 128 experts)
FAMILY_PROFILED = "arctic-480b"


def decode_matches_prefill(dev, cfg, params) -> dict:
    """Decode against prefill in float32 activations on ``params``, batch
    1, ``DECODE_PROMPT`` tokens (seamless: as many frames too): the logits
    of the decode step after a prefill of P tokens against the last
    position of a prefill of all P + 1. Pixtral, prompted with P patch
    embeddings, decodes two tokens one at a time, held to one call of
    ``lm_forward`` with both on the same prefilled state. Within
    ``DECODE_TOL``."""
    from repro_torch.configs.base import serve_policy
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.model_factory import build_model

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, **(
        {"capacity_factor": 16.0} if cfg.num_experts else {}))
    policy = serve_policy()
    model = build_model(cfg32, policy)
    p, v = DECODE_PROMPT, cfg.vocab_size
    host = torch.Generator().manual_seed(1)
    toks = torch.randint(0, v, (1, p + 2), generator=host).to(dev)
    frames = torch.randn((1, p, cfg.d_model), generator=host).to(dev)
    with torch.inference_mode():
        if cfg.input_kind == "embeddings" and cfg.family != "encdec":
            state = model.init_state(1, p + 2, dtype=torch.float32, device=dev)
            _, state = model.prefill(params, state, {"input_embeds": frames})
            one, st = model.decode_step(params, state, {"tokens": toks[:, :1]})
            two, _ = model.decode_step(params, st, {"tokens": toks[:, 1:2]})
            both, _, _ = tf_mod.lm_forward(params, cfg32, policy, tokens=toks[:, :2],
                                           state=state)
            got, want = [one, two], [both[:, 0, :v], both[:, 1, :v]]
        else:
            extra = {"input_embeds": frames} if cfg.family == "encdec" else {}
            state = model.init_state(1, p + 1, dtype=torch.float32, device=dev)
            _, state = model.prefill(params, state, {"tokens": toks[:, :p], **extra})
            step, _ = model.decode_step(params, state, {"tokens": toks[:, p:p + 1]})
            full, _ = model.prefill(
                params, model.init_state(1, p + 1, dtype=torch.float32, device=dev),
                {"tokens": toks[:, :p + 1], **extra})
            got, want = [step], [full]
    out = {"max_abs_diff": 0.0, "abs_max": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs()
        out["max_abs_diff"] = max(out["max_abs_diff"], float(diff.max()))
        out["abs_max"] = max(out["abs_max"], float(w.abs().max()))
        bad = int((diff > DECODE_TOL["atol"] + DECODE_TOL["rtol"] * w.abs()).sum())
        if bad or not torch.isfinite(g).all():
            fail(f"{cfg.name}: decode step {i} vs prefill, float32: {bad} logits "
                 f"outside {DECODE_TOL} (max abs diff {float(diff.max()):.3g})")
    return out


def serve_family(dev, arch: str, layers) -> dict:
    """One family served at full width from 1-bit packed weights through
    ``serve_config`` (``init_packed`` on the card, bf16 activations, f32
    KV cache), launching no kernel; its weight bytes, prefill and decode
    ms (CUDA events), peak memory, a profile where it is
    ``FAMILY_PROFILED``, and ``decode_matches_prefill``."""
    from repro_torch.configs.base import get_config, serve_policy
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.model_factory import build_model

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    policy = serve_policy()
    model = build_model(cfg, policy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = model.init_packed(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    packed_b, bf16_b = _proj_bytes(params)
    res = {"layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "init_packed_s": time.monotonic() - t0, "packed_weight_bytes": packed_b,
           "bf16_weight_bytes": bf16_b, "param_bytes": _nbytes(params)}
    seen = []

    def on_step(step, logits):
        seen.append((tuple(logits.shape), bool(torch.isfinite(logits).all())))

    ops.reset_launches()
    served = serve_config(cfg, policy, batch=FAMILY_BATCH, prompt_len=FAMILY_PROMPT,
                          gen=FAMILY_GEN, seed=0, cache_dtype=torch.float32,
                          device=dev, params=params, on_step=on_step)
    want_shape = (FAMILY_BATCH, cfg.vocab_size)
    if served["tokens"].shape != (FAMILY_BATCH, FAMILY_GEN) or seen != [
            (want_shape, True)] * FAMILY_GEN:
        fail(f"{arch}: tokens {tuple(served['tokens'].shape)}, logits {seen}")
    batch_p = served["batch"]
    with torch.inference_mode():
        state0 = model.init_state(FAMILY_BATCH, FAMILY_PROMPT + FAMILY_GEN,
                                  dtype=torch.float32, device=dev)
        _, state1 = model.prefill(params, state0, batch_p)
        batch_d = {"tokens": served["tokens"][:, -1:]}
        res["prefill_ms"] = events_ms(lambda: model.prefill(params, state0, batch_p),
                                      reps=1, warm=False)
        res["decode_ms_per_token"] = events_ms(
            lambda: model.decode_step(params, state1, batch_d), reps=2, warm=False)
        if arch == FAMILY_PROFILED:
            res["prefill_breakdown"] = device_breakdown(
                lambda: model.prefill(params, state0, batch_p), warm=False)
            res["decode_breakdown"] = device_breakdown(
                lambda: model.decode_step(params, state1, batch_d), warm=False)
        del state0, state1
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    res["decode_vs_prefill"] = decode_matches_prefill(dev, cfg, params)
    torch.cuda.synchronize()
    res["launches"] = dict(ops.LAUNCHES)
    if any(res["launches"].values()):
        fail(f"{arch} serving launched {res['launches']}, expected no kernel")
    dvp = res["decode_vs_prefill"]
    print(f"  {arch} ({cfg.num_layers} layers"
          + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
          + f", d_model {cfg.d_model}): init_packed {res['init_packed_s']:.1f} s; "
          f"projections {packed_b / 1e9:.3f} GB packed vs {bf16_b / 1e9:.2f} GB "
          f"bf16, all params {res['param_bytes'] / 1e9:.2f} GB; batch "
          f"{FAMILY_BATCH} x {FAMILY_PROMPT} prefill {res['prefill_ms']:.1f} ms, "
          f"decode {res['decode_ms_per_token']:.1f} ms a token (CUDA events); peak "
          f"{res['max_memory_allocated'] / 1e9:.2f} GB; no kernel launched; "
          f"float32 decode vs prefill max |diff| {dvp['max_abs_diff']:.3g} "
          f"(|logits| up to {dvp['abs_max']:.3g}, tolerance {DECODE_TOL})",
          flush=True)
    for what in ("prefill", "decode"):
        top = res.get(f"{what}_breakdown")
        if top is None:
            continue
        print(f"    {what} profile: " + (top if isinstance(top, str) else ""),
              flush=True)
        if not isinstance(top, str):
            for kname, ms, share in top:
                print(f"    {ms:10.3f} ms {share:6.1%}  {kname}", flush=True)
    del params
    torch.cuda.empty_cache()
    return res


def families_phase(dev) -> dict:
    """Phase 12: (a) every family of ``FAMILY_SERVE`` served through
    ``serve_family`` (no kernel: the ``xla`` engine, the experts one by
    one, attention over a KV cache, as the JAX package's
    ``serve_policy``); (b) ``FAMILY_TRAIN`` trained through
    ``lm_train_run``; (c) the smoke configs of ``FAMILY_SMOKE`` must
    learn. The launches of (a) are the path ``lm_families_serve``, those
    of (b) and (c) ``lm_families_train``."""
    from repro_torch.kernels import ops

    res = {"serve": {}, "train": {}}
    print("  (a) packed serving launches no kernel, as the JAX package's "
          "serve_policy: each projection unpacked and multiplied in float32 "
          "(engine xla), MoE experts one by one, attention over the KV cache "
          "(never the flash branch)", flush=True)
    serve_total = {name: 0 for name in ops.LAUNCHES}
    for arch, layers in FAMILY_SERVE:
        res["serve"][arch] = r = serve_family(dev, arch, layers)
        for name, n in r["launches"].items():
            serve_total[name] += n
    train_total = {name: 0 for name in ops.LAUNCHES}
    for arch, batch, seq, steps, layers, profile in FAMILY_TRAIN:
        ops.reset_launches()
        res["train"][arch] = r = lm_train_run(dev, arch, batch, seq, steps, layers,
                                              profile=profile)
        for name, n in r["launches"].items():
            train_total[name] += n
    res["smoke"] = smoke_runs(dev, FAMILY_SMOKE, train_total)
    res["launches"] = {"lm_families_serve": serve_total,
                       "lm_families_train": train_total}
    return res


# ----------- phase 13: the dry run's counter and data-parallel training -----

# (arch, batch, seq): phase 11's smollm-360m training batch, full width.
DP_LM_CASE = ("smollm-360m", 4, 4096)
# Replicas of the data-parallel step, sharing one card.
DP_LM_REPLICAS = 2


def dryrun_dp_phase(dev, card: str) -> dict:
    """Phase 13: (a) one data-parallel step (``train.step.
    make_dp_train_step``) of smollm-360m at full width under
    ``train_policy()`` in bf16, batch ``DP_LM_CASE``, on ``DP_LM_REPLICAS``
    replicas sharing the card, and one single-device step on the same
    params and batch: the losses within ``LM_LOSS_TOL`` and the reduced
    gradients (read back from Adam's first moment, 0.1 x the clipped
    gradient) per leaf within phase 11's first-step ``LM_GRAD_TOL``; flash
    attention forward and backward launch exactly ``DP_LM_REPLICAS`` x as
    often as in the single step. (b) The single-device step counted by
    ``roofline.op_cost`` on the card (kernels) and on meta: FLOPs, bytes
    and kernel calls equal; the counted FLOPs, the step's ms (CUDA events)
    and the one-card roofline's ``compute_s`` and ``memory_s`` (the H100's
    published peaks) printed beside the card's name and power limit. The
    DP step's launches are the path ``lm_dp_train``."""
    from repro_torch.configs.base import ShapeConfig, get_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.models.model_factory import build_model
    from repro_torch.roofline import analysis, op_cost
    from repro_torch.train.step import (TrainConfig, init_opt_state,
                                        make_dp_train_step, make_train_step)

    t0 = time.monotonic()
    arch, batch, seq = DP_LM_CASE
    cfg = get_config(arch)
    model = build_model(cfg, train_policy())
    tcfg = TrainConfig()
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = init_opt_state(params)
    b0 = next(synthetic_lm_batches(DataConfig(seed=0, global_batch=batch,
                                              seq_len=seq, vocab_size=cfg.vocab_size)))
    b0 = {"tokens": b0["tokens"].to(dev), "labels": b0["labels"].to(dev)}
    mesh = ServingMesh((dev,) * DP_LM_REPLICAS)
    single = make_train_step(model, tcfg)
    dp = make_dp_train_step(model, tcfg, mesh)

    ops.reset_launches()
    _, opt_one, m_one = single(params, opt, b0)
    torch.cuda.synchronize()
    one = dict(ops.LAUNCHES)
    ops.reset_launches()
    _, opt_dp, m_dp = dp(params, opt, b0)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    rel = _leaf_rel_l2(opt_dp["adam"]["mu"], opt_one["adam"]["mu"])
    del opt_one, opt_dp
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)
    res = {"card": card, "replicas": DP_LM_REPLICAS, "batch": batch, "seq": seq,
           "loss_single": float(m_one["loss"]), "loss_dp": float(m_dp["loss"]),
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2_median": statistics.median(rel.values()),
           "launches_single": {k: v for k, v in one.items() if v},
           "launches": launches}
    print(f"  (a) {arch} batch {batch} x {seq} bf16, {DP_LM_REPLICAS} replicas on one "
          f"card: loss {res['loss_dp']:.5f} (single device {res['loss_single']:.5f}), "
          f"reduced gradients per-leaf rel L2 max {rel[worst]:.3g} ({worst}), median "
          f"{res['grad_rel_l2_median']:.3g}; launches {res['launches_single']} single, "
          f"{ {k: v for k, v in launches.items() if v} } DP [{card}]", flush=True)
    if not abs(res["loss_dp"] - res["loss_single"]) <= LM_LOSS_TOL:
        fail(f"DP step loss {res['loss_dp']} vs single device {res['loss_single']}")
    if rel[worst] > LM_GRAD_TOL["bfloat16"]:
        fail(f"DP step: reduced gradient {worst} rel L2 {rel[worst]:.3g} > "
             f"{LM_GRAD_TOL['bfloat16']} of the single-device step's")
    for name in ("flash_attention", "flash_attention_bwd"):
        if not one[name] or launches[name] != DP_LM_REPLICAS * one[name]:
            fail(f"DP step launched {name} {launches[name]} times, the single "
                 f"step {one[name]}: expected {DP_LM_REPLICAS}x")

    # (b) the single-device step timed, then counted on the card and on meta
    step_ms = events_ms(lambda: single(params, opt, b0), reps=3)
    with op_cost.count() as on_card:
        single(params, opt, b0)
        torch.cuda.synchronize()
    del params, opt
    torch.cuda.empty_cache()
    meta_params = model.init()
    meta_opt = init_opt_state(meta_params)
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in b0.items()}
    with op_cost.count() as on_meta:
        single(meta_params, meta_opt, meta_batch)
    card_c, meta_c = on_card.as_dict(), on_meta.as_dict()
    for key in ("flops", "bytes", "kernels"):
        if card_c[key] != meta_c[key]:
            fail(f"op_cost {key}: {card_c[key]} counted on the card, "
                 f"{meta_c[key]} on meta")
    n_params = analysis.count_params(meta_params)
    shape = ShapeConfig("train", seq, batch, "train")
    rf = analysis.Roofline(
        arch=arch, shape=f"train {batch}x{seq}", mesh="one card", chips=1,
        hlo_flops_per_chip=card_c["flops"], hlo_bytes_per_chip=card_c["bytes"],
        collective_bytes_per_chip=0.0, collective_breakdown={},
        model_flops=analysis.model_flops_for(cfg, shape, n_params, n_params),
        fusible_bytes_per_chip=card_c["fusible_bytes"])
    res.update(counted=card_c, counted_meta=meta_c, step_ms=step_ms,
               roofline=rf.to_dict(), seconds=time.monotonic() - t0)
    print(f"  (b) {arch} step counted on the card and on meta, equal: "
          f"{card_c['flops']:.6g} FLOPs, {card_c['bytes']:.6g} bytes, kernels "
          f"{card_c['kernels']}; the step {step_ms:.2f} ms (CUDA events) against "
          f"the one-card roofline compute_s {rf.compute_s * 1e3:.2f} ms, memory_s "
          f"{rf.memory_s * 1e3:.2f} ms (published peaks: {analysis.PEAK_FLOPS:.3g} "
          f"FLOP/s, {analysis.HBM_BW:.3g} B/s), roofline MFU {rf.mfu:.3f}, "
          f"measured model-FLOP rate {rf.model_flops / (step_ms / 1e3) / 1e12:.1f} "
          f"TFLOP/s [{card}]; phase 13 {res['seconds']:.1f} s", flush=True)
    return res


# ------------- phase 14: tensor parallelism over the model axis -------------

# Phase 14's and 17 (a)'s lockstep steps as phase 18 reads them: the
# gathered first moments of the mesh step and of the single-device step on
# the host, the single step's launches and both losses.
LOCKSTEP: dict = {}


def _host(tree_):
    from repro_torch import tree
    return tree.tree_map(lambda t: t.cpu(), tree_)


def _rule_bytes(mesh, params) -> int:
    """Bytes of one rank's shard of ``params`` by the rule table."""
    from repro_torch import tree
    from repro_torch.distributed import sharding

    return sum(math.prod(sharding.shard_shape(mesh, leaf.shape, sharding.param_spec(
        mesh, path, leaf))) * leaf.element_size()
        for path, leaf in tree.leaves_with_path(params))


def _timed(fn):
    """(``fn()``, ms of the call by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _hold_launches(label: str, one: dict, launches: dict, kernels, ranks: int) -> None:
    for name in kernels:
        if not one[name] or launches[name] != ranks * one[name]:
            fail(f"{label} launched {name} {launches[name]} times, the single "
                 f"device {one[name]}: expected {ranks}x")


# (arch, layers, batch, seq): qwen2.5-3b at its published widths, 8 of its
# 36 layers (depth cut for time).
TP_LM_CASE = ("qwen2.5-3b", 8, 2, 4096)
# Ranks on the model axis, sharing one card.
TP_RANKS = 2


def tp_phase(dev, card: str) -> dict:
    """Phase 14: one tensor-parallel step (``train.step.make_tp_train_step``)
    of ``TP_LM_CASE`` under ``train_policy()`` in bf16 on a (1,
    ``TP_RANKS``) ``("data", "model")`` mesh of ranks sharing the card, and
    one single-device step on the same params and batch. Holds: the losses
    within ``LM_LOSS_TOL``; the gathered gradients (Adam's first moment,
    0.1 x the clipped gradient) per leaf within phase 11's bf16
    ``LM_GRAD_TOL``; flash attention forward and backward launched exactly
    ``TP_RANKS`` x as often as in the single step; each rank's param bytes
    equal to the rule table's shard bytes (``param_spec``,
    ``shard_shape``); the TP step's collective bytes a device as
    ``distributed.tensor_parallel`` counts them equal to the dry run's
    reckoning for the same mesh (:func:`collectives_against_reckoning`).
    Prints the ms of a step of each (CUDA events), their peak memory, and
    the bytes by site. The TP step's launches are the path
    ``lm_tp_train``."""
    from repro_torch.configs.base import get_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.model_factory import build_model
    from repro_torch.train.step import (TrainConfig, init_opt_state,
                                        make_tp_train_step, make_train_step)

    t0 = time.monotonic()
    arch, layers, batch, seq = TP_LM_CASE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg, train_policy())
    tcfg = TrainConfig()
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = init_opt_state(params)
    b0 = next(synthetic_lm_batches(DataConfig(seed=0, global_batch=batch,
                                              seq_len=seq, vocab_size=cfg.vocab_size)))
    b0 = {"tokens": b0["tokens"].to(dev), "labels": b0["labels"].to(dev)}
    mesh = DeviceMesh(np.array([[dev] * TP_RANKS], dtype=object), ("data", "model"))
    single = make_train_step(model, tcfg)
    step = make_tp_train_step(model, tcfg, mesh)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    _, opt_one, m_one = single(params, opt, b0)
    torch.cuda.synchronize()
    one = dict(ops.LAUNCHES)
    peak_single = torch.cuda.max_memory_allocated(dev)
    mu_one = opt_one["adam"]["mu"]
    del opt_one
    sp, so = sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh)
    rank_bytes = [_nbytes(t) for t in sp.rows()[0]]
    rule_bytes = _rule_bytes(mesh, params)
    torch.cuda.empty_cache()
    tp.reset_bytes()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    _, opt_tp, m_tp = step(sp, so, b0)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_tp = torch.cuda.max_memory_allocated(dev)
    counted, by_kind = dict(tp.BYTES), tp.bytes_by_kind()
    mu_tp = sharding.gather_params(opt_tp, mesh)["adam"]["mu"]
    rel = _leaf_rel_l2(mu_tp, mu_one)
    LOCKSTEP["tp"] = {"mu": _host(mu_tp), "mu_one": _host(mu_one), "one": one,
                      "loss": float(m_tp["loss"]), "loss_one": float(m_one["loss"])}
    del opt_tp, mu_one, mu_tp
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)
    single_ms = events_ms(lambda: single(params, opt, b0), reps=2, warm=False)
    tp_ms = events_ms(lambda: step(sp, so, b0), reps=2, warm=False)
    coll = collectives_against_reckoning(mesh, model, b0, counted)
    del params, opt, sp, so
    torch.cuda.empty_cache()
    res = {"card": card, "arch": arch, "layers": layers, "batch": batch, "seq": seq,
           "ranks": TP_RANKS, "loss_single": float(m_one["loss"]),
           "loss_tp": float(m_tp["loss"]), "grad_norm_single": float(m_one["grad_norm"]),
           "grad_norm_tp": float(m_tp["grad_norm"]),
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2_median": statistics.median(rel.values()),
           "launches_single": {k: v for k, v in one.items() if v},
           "launches": launches, "rank_param_bytes": rank_bytes,
           "rule_table_bytes": rule_bytes, "single_ms": single_ms, "tp_ms": tp_ms,
           "peak_single_bytes": peak_single, "peak_tp_bytes": peak_tp,
           "collective_bytes_counted": {f"{k} {s} {d}": n
                                        for (k, s, d), n in sorted(counted.items())},
           "collective_bytes_by_kind": by_kind, "collectives": coll}
    print(f"  {arch} ({layers} of its layers) batch {batch} x {seq} bf16 on a (1, "
          f"{TP_RANKS}) mesh of ranks sharing the card: loss {res['loss_tp']:.5f} "
          f"(single device {res['loss_single']:.5f}), grad norm "
          f"{res['grad_norm_tp']:.6g} ({res['grad_norm_single']:.6g}); gathered "
          f"gradients per-leaf rel L2 max {rel[worst]:.3g} ({worst}), median "
          f"{res['grad_rel_l2_median']:.3g}; launches {res['launches_single']} single, "
          f"{ {k: v for k, v in launches.items() if v} } TP; rank param bytes "
          f"{rank_bytes} (rule table {rule_bytes}) [{card}]", flush=True)
    print(f"  a step {single_ms:.2f} ms single, {tp_ms:.2f} ms TP (CUDA events); "
          f"peak memory {peak_single / 2**30:.2f} GiB single, {peak_tp / 2**30:.2f} GiB "
          f"TP (both ranks, with the single step's params and state) [{card}]",
          flush=True)
    print_collectives(counted, coll)
    if not abs(res["loss_tp"] - res["loss_single"]) <= LM_LOSS_TOL:
        fail(f"TP step loss {res['loss_tp']} vs single device {res['loss_single']}")
    if rel[worst] > LM_GRAD_TOL["bfloat16"]:
        fail(f"TP step: gathered gradient {worst} rel L2 {rel[worst]:.3g} > "
             f"{LM_GRAD_TOL['bfloat16']} of the single-device step's")
    _hold_launches("TP step", one, launches, ("flash_attention", "flash_attention_bwd"),
                   TP_RANKS)
    if rank_bytes != [rule_bytes] * TP_RANKS:
        fail(f"TP ranks hold {rank_bytes} param bytes, the rule table's shards "
             f"{rule_bytes}")
    hold_collectives("TP step", coll)
    res["seconds"] = time.monotonic() - t0
    print(f"  phase 14 {res['seconds']:.1f} s", flush=True)
    return res


def collectives_against_reckoning(mesh, model, b0, counted: dict) -> dict:
    """A TP step's collectives as ``distributed.tensor_parallel.BYTES``
    counted them (``counted``), summed by kind and direction, beside the dry
    run's reckoning for the same mesh and batch: ``op_cost.
    collective_bytes`` (one forward) plus ``op_cost.collective_bytes_bwd``
    (remat's recompute, the backward, the embedding, gathers and loss;
    ``train_policy()``'s alpha). Returns both and the worst relative gap."""
    args = (model.init(), None, {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                                 for k, v in b0.items()})
    return reckoning_gap(mesh, args, model.cfg, counted)


def reckoning_gap(mesh, args, cfg, counted: dict) -> dict:
    """``counted`` (``tensor_parallel.BYTES``) summed by kind and direction
    beside ``op_cost.collective_bytes`` + ``collective_bytes_bwd`` of a
    train cell's ``args`` (meta params, no state, meta batch) on ``mesh``:
    both, and the worst relative gap."""
    from repro_torch.roofline import op_cost

    got = _by_kind_direction(counted)
    act = torch.empty((), dtype=cfg.dtype).element_size()
    want: dict = collections.Counter(
        {f"{k} {d}": v for (k, d), v in op_cost.collective_bytes_bwd(
            mesh, args, "train", cfg).items()})
    for (kind, d), v in op_cost.collective_bytes(mesh, args, "train", act_bytes=act,
                                                 by_direction=True).items():
        want[f"{kind} {d}"] += v
    keys = sorted(k for k in set(got) | set(want) if got[k] or want[k])
    worst = max(abs(got[k] - want[k]) / max(got[k], want[k]) for k in keys)
    return {"counted": {k: got[k] for k in keys},
            "reckoned": {k: want[k] for k in keys}, "worst_rel": worst}


def _by_kind_direction(counted: dict) -> collections.Counter:
    """``tensor_parallel.BYTES`` summed by kind and direction."""
    got: collections.Counter = collections.Counter()
    for (kind, _, direction), n in counted.items():
        got[f"{kind} {direction}"] += n
    return got


def print_collectives(counted: dict, coll: dict) -> None:
    print("  collective bytes a device, counted in the TP step, beside the dry "
          "run's reckoning (op_cost.collective_bytes + collective_bytes_bwd): "
          + ", ".join(f"{k} {coll['counted'][k]:.6g} ({coll['reckoned'][k]:.6g})"
                      for k in coll["counted"])
          + f"; worst relative gap {coll['worst_rel']:.3g}", flush=True)
    for (kind, site, direction), n in sorted(counted.items()):
        print(f"    {kind} {site} {direction}: {n:.6g}", flush=True)


def hold_collectives(label: str, coll: dict) -> None:
    if coll["worst_rel"] > 1e-9:
        fail(f"{label}: counted collective bytes {coll['counted']} are not the "
             f"dry run's reckoning {coll['reckoned']}")


# ------------- phase 15: expert parallelism over the model axis -------------

# (arch, layers, batch, seq): moonshot-v1-16b-a3b at its published widths
# (64 experts of d_ff 1408, top-6, C = 480), 2 of its 48 layers (depth cut
# for memory: 1.8122e9 float32 params, 7.25 GB, with the untied head).
EP_LM_CASE = ("moonshot-v1-16b-a3b", 2, 2, 4096)
# Ranks on the model axis, sharing one card.
EP_RANKS = 2
# arctic's dense residual branch beside its experts: the smoke config
# (float32), batch x seq, on the same mesh.
EP_SMOKE_CASE = ("arctic-480b", 8, 64)


def routing_flips(routes_one: list, routes_ep: list, layers: int,
                  ranks: int) -> list:
    """Per MoE layer of the forward, the (token, slot) pairs whose expert
    differs between the single-device step and the EP step's rank 0 (the
    collectors hold the forward's routes first, remat's after), and
    whether every rank of the EP step routed alike."""
    out = []
    for layer in range(layers):
        one = routes_one[layer][0]
        ep = [routes_ep[layer * ranks + r][0] for r in range(ranks)]
        out.append({"flips": int((ep[0] != one).sum()),
                    "pairs": one.numel(),
                    "ranks_agree": all(torch.equal(e, ep[0]) for e in ep)})
    return out


def ep_smoke_step(dev, mesh) -> dict:
    """arctic's smoke config (``moe+dense``: the experts and the dense
    residual FFN) under ``train_policy()``: one EP step on ``mesh`` and one
    single-device step, loss within ``LM_LOSS_TOL`` and gathered gradients
    within the float32 ``LM_GRAD_TOL``."""
    from repro_torch.configs.base import smoke_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.distributed import sharding
    from repro_torch.models.model_factory import build_model
    from repro_torch.train.step import (TrainConfig, init_opt_state,
                                        make_tp_train_step, make_train_step)

    arch, batch, seq = EP_SMOKE_CASE
    cfg = smoke_config(arch)
    model = build_model(cfg, train_policy())
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = init_opt_state(params)
    b0 = next(synthetic_lm_batches(DataConfig(seed=0, global_batch=batch,
                                              seq_len=seq, vocab_size=cfg.vocab_size)))
    b0 = {"tokens": b0["tokens"].to(dev), "labels": b0["labels"].to(dev)}
    _, opt_one, m_one = make_train_step(model, TrainConfig())(params, opt, b0)
    _, opt_ep, m_ep = make_tp_train_step(model, TrainConfig(), mesh)(
        sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh), b0)
    rel = _leaf_rel_l2(sharding.gather_params(opt_ep, mesh)["adam"]["mu"],
                       opt_one["adam"]["mu"])
    worst = max(rel, key=rel.get)
    res = {"arch": arch, "batch": batch, "seq": seq,
           "loss_single": float(m_one["loss"]), "loss_ep": float(m_ep["loss"]),
           "aux_single": float(m_one["aux"]), "aux_ep": float(m_ep["aux"]),
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst}
    print(f"  {arch} smoke config (moe+dense) batch {batch} x {seq} float32: loss "
          f"{res['loss_ep']:.6f} EP ({res['loss_single']:.6f} single), aux "
          f"{res['aux_ep']:.6f} ({res['aux_single']:.6f}); gathered gradients "
          f"per-leaf rel L2 max {rel[worst]:.3g} ({worst})", flush=True)
    if not abs(res["loss_ep"] - res["loss_single"]) <= LM_LOSS_TOL:
        fail(f"{arch} EP step loss {res['loss_ep']} vs single {res['loss_single']}")
    if not abs(res["aux_ep"] - res["aux_single"]) <= LM_LOSS_TOL:
        fail(f"{arch} EP step aux {res['aux_ep']} vs single {res['aux_single']}")
    if rel[worst] > LM_GRAD_TOL["float32"]:
        fail(f"{arch} EP step: gathered gradient {worst} rel L2 {rel[worst]:.3g} "
             f"> {LM_GRAD_TOL['float32']} of the single-device step's")
    return res


def ep_phase(dev, card: str) -> dict:
    """Phase 15: one expert-parallel step (``train.step.make_tp_train_step``)
    of ``EP_LM_CASE`` under ``train_policy()`` in bf16 on a (1,
    ``EP_RANKS``) ``("data", "model")`` mesh of ranks sharing the card (the
    experts, attention heads and vocab split over the ranks by the rule
    table), and one single-device step on the same params and batch.
    Holds: the losses and the balance losses within ``LM_LOSS_TOL``; the
    gathered gradients (Adam's first moment) per leaf within phase 11's
    bf16 ``LM_GRAD_TOL``; flash attention forward and backward launched
    exactly ``EP_RANKS`` x as often as in the single step; each rank's
    param bytes the rule table's shard bytes; the counted collective bytes
    the dry run's reckoning. Prints the ms of a step of each (CUDA events,
    the second call of each), their peak memory, the bytes by site and the
    (token, slot) pairs routed to another expert than the single step's,
    layer by layer. The single step runs first; its first moment and
    metrics go to the host and its trees leave the card before the EP
    step. Then ``EP_SMOKE_CASE`` (:func:`ep_smoke_step`). The EP step's
    launches are the path ``lm_ep_train``."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import ffn
    from repro_torch.models.model_factory import build_model
    from repro_torch.train.step import (TrainConfig, init_opt_state,
                                        make_tp_train_step, make_train_step)

    t0 = time.monotonic()
    arch, layers, batch, seq = EP_LM_CASE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg, train_policy())
    tcfg = TrainConfig()
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = init_opt_state(params)
    b0 = next(synthetic_lm_batches(DataConfig(seed=0, global_batch=batch,
                                              seq_len=seq, vocab_size=cfg.vocab_size)))
    b0 = {"tokens": b0["tokens"].to(dev), "labels": b0["labels"].to(dev)}
    mesh = DeviceMesh(np.array([[dev] * EP_RANKS], dtype=object), ("data", "model"))
    single = make_train_step(model, tcfg)
    step = make_tp_train_step(model, tcfg, mesh)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with ffn.routing() as routes:
        new_p, opt_one, m_one = single(params, opt, b0)
    torch.cuda.synchronize()
    one = dict(ops.LAUNCHES)
    peak_single = torch.cuda.max_memory_allocated(dev)
    mu_one = tree.tree_map(lambda t: t.cpu(), opt_one["adam"]["mu"])
    m_one = {k: float(v) for k, v in m_one.items()}
    routes_one = [tuple(t.cpu() for t in r) for r in routes]
    del new_p, opt_one, routes
    torch.cuda.empty_cache()
    single_ms = events_ms(lambda: single(params, opt, b0), reps=1, warm=False)
    sp, so = sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh)
    rank_bytes = [_nbytes(t) for t in sp.rows()[0]]
    rule_bytes = _rule_bytes(mesh, params)
    whole_bytes = _nbytes(params)
    del params, opt
    torch.cuda.empty_cache()
    tp.reset_bytes()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with ffn.routing() as routes:
        new_p, opt_ep, m_ep = step(sp, so, b0)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_ep = torch.cuda.max_memory_allocated(dev)
    counted = dict(tp.BYTES)
    routes_ep = [tuple(t.cpu() for t in r) for r in routes]
    mu_ep = tree.tree_map(lambda t: t.cpu(),
                          sharding.gather_params(opt_ep, mesh)["adam"]["mu"])
    m_ep = {k: float(v) for k, v in m_ep.items()}
    del new_p, opt_ep, routes
    torch.cuda.empty_cache()
    ep_ms = events_ms(lambda: step(sp, so, b0), reps=1, warm=False)
    del sp, so
    torch.cuda.empty_cache()
    rel = _leaf_rel_l2(mu_ep, mu_one)
    worst = max(rel, key=rel.get)
    flips = routing_flips(routes_one, routes_ep, layers, EP_RANKS)
    coll = collectives_against_reckoning(mesh, model, b0, counted)
    res = {"card": card, "arch": arch, "layers": layers, "batch": batch, "seq": seq,
           "ranks": EP_RANKS, "loss_single": m_one["loss"], "loss_ep": m_ep["loss"],
           "aux_single": m_one["aux"], "aux_ep": m_ep["aux"],
           "grad_norm_single": m_one["grad_norm"], "grad_norm_ep": m_ep["grad_norm"],
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2_median": statistics.median(rel.values()),
           "routing": flips, "launches_single": {k: v for k, v in one.items() if v},
           "launches": launches, "rank_param_bytes": rank_bytes,
           "rule_table_bytes": rule_bytes, "whole_param_bytes": whole_bytes,
           "single_ms": single_ms, "ep_ms": ep_ms,
           "peak_single_bytes": peak_single, "peak_ep_bytes": peak_ep,
           "collective_bytes_counted": {f"{k} {s} {d}": n
                                        for (k, s, d), n in sorted(counted.items())},
           "collectives": coll}
    print(f"  {arch} ({layers} of its layers) batch {batch} x {seq} bf16 on a (1, "
          f"{EP_RANKS}) mesh of ranks sharing the card: loss {res['loss_ep']:.5f} "
          f"(single device {res['loss_single']:.5f}), aux {res['aux_ep']:.6f} "
          f"({res['aux_single']:.6f}), grad norm {res['grad_norm_ep']:.6g} "
          f"({res['grad_norm_single']:.6g}); gathered gradients per-leaf rel L2 max "
          f"{rel[worst]:.3g} ({worst}), median {res['grad_rel_l2_median']:.3g}; "
          f"launches {res['launches_single']} single, "
          f"{ {k: v for k, v in launches.items() if v} } EP; rank param bytes "
          f"{rank_bytes} (rule table {rule_bytes}, whole {whole_bytes}) [{card}]",
          flush=True)
    print(f"  routing, EP rank 0 against the single step, layer by layer: "
          + ", ".join(f"{f['flips']} of {f['pairs']} (token, slot) pairs to another "
                      f"expert, ranks agree {f['ranks_agree']}" for f in flips),
          flush=True)
    print(f"  a step {single_ms:.2f} ms single, {ep_ms:.2f} ms EP (CUDA events, "
          f"the second call of each); peak memory {peak_single / 2**30:.2f} GiB "
          f"single, {peak_ep / 2**30:.2f} GiB EP (both ranks) [{card}]", flush=True)
    print_collectives(counted, coll)
    if not abs(res["loss_ep"] - res["loss_single"]) <= LM_LOSS_TOL:
        fail(f"EP step loss {res['loss_ep']} vs single device {res['loss_single']}")
    if not abs(res["aux_ep"] - res["aux_single"]) <= LM_LOSS_TOL:
        fail(f"EP step aux {res['aux_ep']} vs single device {res['aux_single']}")
    if rel[worst] > LM_GRAD_TOL["bfloat16"]:
        fail(f"EP step: gathered gradient {worst} rel L2 {rel[worst]:.3g} > "
             f"{LM_GRAD_TOL['bfloat16']} of the single-device step's")
    _hold_launches("EP step", one, launches, ("flash_attention", "flash_attention_bwd"),
                   EP_RANKS)
    if rank_bytes != [rule_bytes] * EP_RANKS:
        fail(f"EP ranks hold {rank_bytes} param bytes, the rule table's shards "
             f"{rule_bytes}")
    if not all(f["ranks_agree"] for f in flips):
        fail("EP step: the ranks routed the same tokens differently")
    hold_collectives("EP step", coll)
    res["smoke"] = ep_smoke_step(dev, mesh)
    res["seconds"] = time.monotonic() - t0
    print(f"  phase 15 {res['seconds']:.1f} s", flush=True)
    return res


# ---- phase 16: mamba, the xLSTM and the encoder-decoder on the model axis ----

# Ranks on the model axis, sharing one card.
SSM_TP_RANKS = 2
# (arch, batch, seq): jamba's mamba block at its published widths; one
# full-width period (8 layers, 44.2 G params, 177 GB in float32) does not
# train on one card.
TP_MAMBA_CASE = ("jamba-1.5-large-398b", 2, 4096)
# (arch, batch, seq): jamba's smoke config, its hybrid period whole.
TP_HYBRID_SMOKE_CASE = ("jamba-1.5-large-398b", 8, 64)
# (arch, layers, batch, seq): xlstm-1.3b, one 8-layer period of its 48
# (7 mLSTM, 1 sLSTM), for time, in float32 activations (in bf16 an ulp of
# an mLSTM output moves its logits by O(1), so two sum orders would not
# agree in bf16 whatever the code).
TP_XLSTM_CASE = ("xlstm-1.3b", 8, 2, 4096)
# (arch, encoder and decoder layers, batch, seq): seamless-m4t-large-v2,
# 4 + 4 of its 24 + 24 layers, for time.
TP_ENCDEC_CASE = ("seamless-m4t-large-v2", 4, 2, 4096)


def mamba_block_tp(dev, card: str, mesh) -> dict:
    """Part (a) of phase 16: ``mamba.mamba`` of ``TP_MAMBA_CASE``'s config
    under ``train_policy()`` in bf16, forward and backward under remat (a
    period's checkpoint, early stop off) on one device and on ``mesh``'s
    ranks (a ``RankedTree`` of the block laid out by the rule table), the
    same params, input and output weights. Holds the output, the input's
    gradient and every param's gradient (the ranks' gathered, the
    replicated leaves' summed) per tensor rel L2 within the bf16
    ``LM_GRAD_TOL``; the scan and its backward launched exactly ``ranks``
    x as often; rank bytes; collective bytes against the reckoning of a
    one-layer stack of the block (no vocab split: a 1-row table)."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    from repro_torch import tree
    from repro_torch.configs.base import get_config, train_policy
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import ops
    from repro_torch.models import mamba
    from repro_torch.train.step import _sum_replicated

    arch, batch, seq = TP_MAMBA_CASE
    cfg, policy, ranks = get_config(arch), train_policy(), SSM_TP_RANKS
    gen = torch.Generator(dev).manual_seed(0)
    block = mamba.init_mamba(gen, cfg)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    w = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)

    def run(params, xx, ranked: bool):
        def body(xb, pb):
            xin = tp.Ranked([xb] * ranks, (None, None, None)) if ranked else xb
            out, _ = mamba.mamba(pb, xin, cfg, policy)
            return out.parts[0] if ranked else out

        with set_checkpoint_early_stop(False):
            return checkpoint(body, xx, params, use_reentrant=False,
                              preserve_rng_state=False)

    live = tree.tree_map(lambda t: t.detach().requires_grad_(True), block)
    xs = x.clone().requires_grad_(True)
    ops.reset_launches()

    def single():
        out = run(live, xs, False)
        return out, torch.autograd.grad((out.float() * w).sum(), [xs] + tree.leaves(live))

    out_one, g_one = single()
    one = dict(ops.LAUNCHES)
    out_one = out_one.detach()
    single_ms = events_ms(single, reps=1, warm=False)
    shards = sharding.shard_params({"block": block}, mesh)
    rank_bytes = [_nbytes(t) for t in shards.rows()[0]]
    rule_bytes = _rule_bytes(mesh, {"block": block})
    rows = [tree.tree_map(lambda t: t.detach().requires_grad_(True), t)
            for t in shards.rows()[0]]
    ranked = tp.RankedTree(rows, shards.specs)["block"]
    xr = x.clone().requires_grad_(True)
    tp.reset_bytes()
    ops.reset_launches()

    def tp_call():
        out = run(ranked, xr, True)
        flat = [leaf for t in rows for leaf in tree.leaves(t)]
        return out, torch.autograd.grad((out.float() * w).sum(), [xr] + flat)

    out_tp, g_tp = tp_call()
    launches, counted = dict(ops.LAUNCHES), dict(tp.BYTES)
    out_tp = out_tp.detach()
    tp_ms = events_ms(tp_call, reps=1, warm=False)
    n = len(tree.leaves(block))
    per_rank = [tree.tree_map(lambda _, it=iter(g_tp[1 + r * n:]): next(it), {"block": block})
                for r in range(ranks)]
    grads = sharding.gather_params(sharding.Shards(
        _sum_replicated(per_rank, shards.specs), shards.specs, mesh), mesh)["block"]
    rel = {"output": _leaf_rel_l2(out_tp, out_one)[""],
           "x": _leaf_rel_l2(g_tp[0], g_one[0])[""],
           **_leaf_rel_l2(grads, tree.tree_map(lambda _, it=iter(g_one[1:]): next(it), block))}
    del g_one, g_tp, grads, per_rank, out_one, out_tp

    # the reckoning of a one-layer stack of the block; a 1-row table splits
    # no vocab
    meta = {"embed": {"table": torch.empty((1, cfg.d_model), device="meta")},
            "layers": [{"mamba": tree.tree_map(
                lambda t: torch.empty((1, *t.shape), dtype=t.dtype, device="meta"),
                block)}]}
    args = (meta, None, {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                               device="meta")})
    coll = reckoning_gap(mesh, args, cfg, counted)
    worst = max(rel, key=rel.get)
    res = {"arch": arch, "d_model": cfg.d_model, "d_inner": cfg.d_inner,
           "d_state": cfg.d_state, "dt_rank": mamba._dt_rank(cfg), "batch": batch,
           "seq": seq, "rel_l2": rel, "rel_l2_max": rel[worst], "rel_l2_worst": worst,
           "launches_single": {k: v for k, v in one.items() if v},
           "launches": launches, "rank_param_bytes": rank_bytes,
           "rule_table_bytes": rule_bytes, "single_ms": single_ms, "tp_ms": tp_ms,
           "collective_bytes_counted": {f"{k} {s} {d}": v
                                        for (k, s, d), v in sorted(counted.items())},
           "collectives": coll}
    print(f"  (a) {arch}'s mamba block (d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"d_state {cfg.d_state}, dt rank {res['dt_rank']}) batch {batch} x {seq} bf16, "
          f"forward and backward under remat: rel L2 output {rel['output']:.3g}, "
          f"input gradient {rel['x']:.3g}, worst {rel[worst]:.3g} ({worst}); launches "
          f"{res['launches_single']} single, { {k: v for k, v in launches.items() if v} } "
          f"TP; rank param bytes {rank_bytes} (rule table {rule_bytes}); "
          f"{single_ms:.2f} ms single, {tp_ms:.2f} ms TP (CUDA events, the second "
          f"call of each) [{card}]", flush=True)
    print_collectives(counted, coll)
    if rel[worst] > LM_GRAD_TOL["bfloat16"]:
        fail(f"mamba block TP: {worst} rel L2 {rel[worst]:.3g} > "
             f"{LM_GRAD_TOL['bfloat16']} of the single device's")
    _hold_launches("mamba block TP", one, launches,
                   ("ssm_scan_chunk", "ssm_scan_chunk_bwd"), ranks)
    if rank_bytes != [rule_bytes] * ranks:
        fail(f"mamba block ranks hold {rank_bytes} bytes, the rule table's {rule_bytes}")
    hold_collectives("mamba block TP", coll)
    return res


def tp_step_part(dev, card: str, mesh, label: str, model, b0: dict, kernels,
                 retime: bool = True, keep: str | None = None) -> dict:
    """One ``make_tp_train_step`` step of ``model`` (``train_policy()``) on
    ``mesh`` and one single-device step first, on the same params (a
    seeded generator on the card) and batch ``b0``: the loss within
    ``LM_LOSS_TOL``, the gathered first moments per leaf within
    ``LM_GRAD_TOL`` of the config's dtype, ``kernels`` launched exactly
    as often forward and backward as the mesh has devices times the
    single step, each device's param and optimizer bytes the rule table's
    (``_rule_bytes``), counted collective bytes the reckoning. The single step's
    first moment goes to the host and its trees leave the card first.
    Each step's ms is a second call's (CUDA events) with ``retime``, else
    the checked call's. With ``keep`` both first moments, the single
    step's launches and both losses stay on the host in ``LOCKSTEP[keep]``
    (phase 18 holds the SPMD step to them)."""
    from repro_torch import tree
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import ops
    from repro_torch.train.step import (TrainConfig, init_opt_state,
                                        make_tp_train_step, make_train_step)

    ranks, tcfg = len(sharding.flat_devices(mesh)), TrainConfig()
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = init_opt_state(params)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    single = make_train_step(model, tcfg)
    (new_p, opt_one, m_one), single_ms = _timed(lambda: single(params, opt, b0))
    one = dict(ops.LAUNCHES)
    peak_single = torch.cuda.max_memory_allocated(dev)
    mu_one = tree.tree_map(lambda t: t.cpu(), opt_one["adam"]["mu"])
    m_one = {k: float(v) for k, v in m_one.items()}
    del new_p, opt_one
    if retime:
        torch.cuda.empty_cache()
        single_ms = events_ms(lambda: single(params, opt, b0), reps=1, warm=False)
    sp, so = sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh)
    rank_bytes, opt_bytes = [_nbytes(t) for t in sp], [_nbytes(t) for t in so]
    rule_bytes, rule_opt_bytes = _rule_bytes(mesh, params), _rule_bytes(mesh, opt)
    del params, opt
    torch.cuda.empty_cache()
    tp.reset_bytes()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    step = make_tp_train_step(model, tcfg, mesh)
    (new_p, opt_tp, m_tp), tp_ms = _timed(lambda: step(sp, so, b0))
    launches, counted = dict(ops.LAUNCHES), dict(tp.BYTES)
    peak_tp = torch.cuda.max_memory_allocated(dev)
    mu_tp = tree.tree_map(lambda t: t.cpu(), sharding.gather_params(opt_tp, mesh)["adam"]["mu"])
    m_tp = {k: float(v) for k, v in m_tp.items()}
    del new_p, opt_tp
    torch.cuda.empty_cache()
    if retime:
        tp_ms = events_ms(lambda: step(sp, so, b0), reps=1, warm=False)
    del sp, so
    torch.cuda.empty_cache()
    rel = _leaf_rel_l2(mu_tp, mu_one)
    worst = max(rel, key=rel.get)
    dname = str(model.cfg.dtype)[6:]
    if keep:
        LOCKSTEP[keep] = {"mu": mu_tp, "mu_one": mu_one, "one": one,
                          "loss": m_tp["loss"], "loss_one": m_one["loss"]}
    coll = collectives_against_reckoning(mesh, model, b0, counted)
    res = {"loss_single": m_one["loss"], "loss_tp": m_tp["loss"],
           "grad_norm_single": m_one["grad_norm"], "grad_norm_tp": m_tp["grad_norm"],
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2_median": statistics.median(rel.values()),
           "launches_single": {k: v for k, v in one.items() if v},
           "launches": launches, "rank_param_bytes": rank_bytes,
           "rule_table_bytes": rule_bytes, "rank_opt_bytes": opt_bytes,
           "rule_table_opt_bytes": rule_opt_bytes, "single_ms": single_ms,
           "tp_ms": tp_ms, "peak_single_bytes": peak_single, "peak_tp_bytes": peak_tp,
           "collective_bytes_counted": {f"{k} {s} {d}": n
                                        for (k, s, d), n in sorted(counted.items())},
           "collectives": coll}
    print(f"  {label}: loss {m_tp['loss']:.6f} TP ({m_one['loss']:.6f} single), grad "
          f"norm {m_tp['grad_norm']:.6g} ({m_one['grad_norm']:.6g}); gathered gradients "
          f"per-leaf rel L2 max {rel[worst]:.3g} ({worst}), median "
          f"{res['grad_rel_l2_median']:.3g} ({dname}); launches {res['launches_single']} "
          f"single, { {k: v for k, v in launches.items() if v} } TP; rank param bytes "
          f"{rank_bytes} (rule table {rule_bytes}); a step {single_ms:.2f} ms single, "
          f"{tp_ms:.2f} ms TP (CUDA events, {'a second' if retime else 'the checked'} "
          f"call of each); peak "
          f"{peak_single / 2**30:.2f} / {peak_tp / 2**30:.2f} GiB [{card}]", flush=True)
    print_collectives(counted, coll)
    if not abs(m_tp["loss"] - m_one["loss"]) <= LM_LOSS_TOL:
        fail(f"{label}: TP loss {m_tp['loss']} vs single device {m_one['loss']}")
    if rel[worst] > LM_GRAD_TOL[dname]:
        fail(f"{label}: gathered gradient {worst} rel L2 {rel[worst]:.3g} > "
             f"{LM_GRAD_TOL[dname]} of the single-device step's")
    _hold_launches(label, one, launches, kernels, ranks)
    if rank_bytes != [rule_bytes] * ranks:
        fail(f"{label}: ranks hold {rank_bytes} param bytes, the rule table's {rule_bytes}")
    if opt_bytes != [rule_opt_bytes] * ranks:
        fail(f"{label}: ranks hold {opt_bytes} optimizer bytes, the rule table's "
             f"{rule_opt_bytes}")
    hold_collectives(label, coll)
    return res


def _lm_batch(dev, cfg, batch: int, seq: int) -> dict:
    """The launcher's first batch (seed 0), with its stub embeddings for a
    config fed by them (the encoder-decoder keeps its tokens too)."""
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.launch.train import stub_embeddings

    b0 = next(synthetic_lm_batches(DataConfig(seed=0, global_batch=batch, seq_len=seq,
                                              vocab_size=cfg.vocab_size)))
    out = {"tokens": b0["tokens"].to(dev), "labels": b0["labels"].to(dev)}
    if cfg.input_kind == "embeddings":
        out["input_embeds"] = stub_embeddings(b0["tokens"], cfg.d_model).to(dev)
    return out


def ssm_tp_phase(dev, card: str) -> dict:
    """Phase 16: mamba, the xLSTM and the encoder-decoder trained over a
    (1, ``SSM_TP_RANKS``) ``("data", "model")`` mesh of ranks sharing the
    card, each part against one device (module docstring, 16): (a)
    :func:`mamba_block_tp`; (b)-(d) :func:`tp_step_part` of jamba's smoke
    config, xlstm-1.3b (float32) and seamless-m4t-large-v2 (bf16). The
    parts' TP launches, summed, are the path ``lm_tp_ssm_train``."""
    from repro_torch.configs.base import get_config, smoke_config, train_policy
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.model_factory import build_model

    t0 = time.monotonic()
    mesh = DeviceMesh(np.array([[dev] * SSM_TP_RANKS], dtype=object), ("data", "model"))
    res, seconds = {}, {}

    def part(name: str, fn):
        t = time.monotonic()
        res[name] = fn()
        seconds[name] = time.monotonic() - t
        print(f"  phase 16 ({name}) {seconds[name]:.1f} s", flush=True)
        torch.cuda.empty_cache()

    part("a", lambda: mamba_block_tp(dev, card, mesh))

    arch, batch, seq = TP_HYBRID_SMOKE_CASE
    cfg = smoke_config(arch)
    part("b", lambda: tp_step_part(
        dev, card, mesh, f"(b) {arch} smoke config batch {batch} x {seq} float32",
        build_model(cfg, train_policy()), _lm_batch(dev, cfg, batch, seq),
        ("ssm_scan_chunk", "ssm_scan_chunk_bwd")))

    arch, layers, batch, seq = TP_XLSTM_CASE
    xcfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=torch.float32)
    part("c", lambda: tp_step_part(
        dev, card, mesh, f"(c) {arch} ({layers} of its layers) batch {batch} x {seq} "
        "float32", build_model(xcfg, train_policy()), _lm_batch(dev, xcfg, batch, seq),
        ("mlstm_chunked", "mlstm_chunked_bwd"), retime=False))

    arch, layers, batch, seq = TP_ENCDEC_CASE
    ecfg = dataclasses.replace(get_config(arch), num_layers=layers, encoder_layers=layers)
    part("d", lambda: tp_step_part(
        dev, card, mesh, f"(d) {arch} ({layers} + {layers} of its layers) batch "
        f"{batch} x {seq} bf16", build_model(ecfg, train_policy()),
        _lm_batch(dev, ecfg, batch, seq), ("flash_attention", "flash_attention_bwd")))

    launches = collections.Counter()
    for r in res.values():
        launches.update(r["launches"])
    out = {"card": card, "ranks": SSM_TP_RANKS, "parts": res, "part_seconds": seconds,
           "launches": {k: launches[k] for k in res["a"]["launches"]},
           "seconds": time.monotonic() - t0}
    print(f"  phase 16 {out['seconds']:.1f} s", flush=True)
    return out


# ------- phase 17: fully sharded data parallelism over a (2, 2) mesh -------

# The (data, model) mesh of phase 17: four ranks sharing the card.
FSDP_MESH = (2, 2)
# (arch, batch, seq): part (b), jamba's smoke config in float32.
FSDP_HYBRID_SMOKE_CASE = ("jamba-1.5-large-398b", 8, 64)


def fsdp_phase(dev, card: str, tp_run: dict) -> dict:
    """Phase 17: :func:`tp_step_part` on a ``FSDP_MESH`` ``("data",
    "model")`` mesh of ranks sharing the card (module docstring, 17): (a)
    ``TP_LM_CASE`` in bf16, beside phase 14's (1, 2) step (``tp_run``);
    (b) ``FSDP_HYBRID_SMOKE_CASE`` in float32. The parts' launches,
    summed, are the path ``lm_fsdp_train``."""
    from repro_torch.configs.base import get_config, smoke_config, train_policy
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.model_factory import build_model

    t0 = time.monotonic()
    mesh = DeviceMesh(np.full(FSDP_MESH, dev, dtype=object), ("data", "model"))
    res, seconds = {}, {}

    def part(name: str, fn):
        t = time.monotonic()
        res[name] = fn()
        seconds[name] = time.monotonic() - t
        print(f"  phase 17 ({name}) {seconds[name]:.1f} s", flush=True)
        torch.cuda.empty_cache()

    arch, layers, batch, seq = TP_LM_CASE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    part("a", lambda: tp_step_part(
        dev, card, mesh, f"(a) {arch} ({layers} of its layers) batch {batch} x {seq} "
        f"bf16 on a {FSDP_MESH} mesh", build_model(cfg, train_policy()),
        _lm_batch(dev, cfg, batch, seq), ("flash_attention", "flash_attention_bwd"),
        keep="fsdp"))
    a = res["a"]
    print(f"  (a) a step {a['tp_ms']:.2f} ms FSDP on {FSDP_MESH}, {tp_run['tp_ms']:.2f} ms "
          f"TP on (1, {TP_RANKS}) (phase 14), {a['single_ms']:.2f} ms single; peak "
          f"{a['peak_tp_bytes'] / 2**30:.2f} GiB FSDP (the single step's trees freed "
          f"first), {tp_run['peak_tp_bytes'] / 2**30:.2f} GiB TP (with the single step's "
          f"params and state on the card) [{card}]", flush=True)
    print(f"  (a) param bytes at rest a device: {a['rank_param_bytes']} FSDP, "
          f"{tp_run['rank_param_bytes']} TP (phase 14); optimizer bytes "
          f"{a['rank_opt_bytes']} FSDP. The four devices are ranks sharing one card, so "
          "their blocks add up to the whole model there: no saving shows on one card",
          flush=True)

    arch, batch, seq = FSDP_HYBRID_SMOKE_CASE
    scfg = smoke_config(arch)
    part("b", lambda: tp_step_part(
        dev, card, mesh, f"(b) {arch} smoke config batch {batch} x {seq} float32 on a "
        f"{FSDP_MESH} mesh", build_model(scfg, train_policy()),
        _lm_batch(dev, scfg, batch, seq), ("ssm_scan_chunk", "ssm_scan_chunk_bwd")))

    launches = collections.Counter()
    for r in res.values():
        launches.update(r["launches"])
    out = {"card": card, "mesh": list(FSDP_MESH), "parts": res, "part_seconds": seconds,
           "launches": {k: launches[k] for k in res["a"]["launches"]},
           "seconds": time.monotonic() - t0}
    print(f"  phase 17 {out['seconds']:.1f} s", flush=True)
    return out



# ---------------- phase 18: one process a device (SPMD) ----------------------

# (c)'s steps of the BNN's sign-SGD DP step, two processes against phase
# 10's lockstep step on two replicas.
SPMD_BNN_STEPS = 3
SPMD_RANKS = 2


def _child_flags() -> None:
    """A spawned process's math settings: ``main``'s (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _spmd_tp_step(mesh_shape, retime: bool) -> dict:
    """Phase 18 (a) / (b), in one process of a world of ``prod(mesh_shape)``:
    ``TP_LM_CASE`` as phases 14 and 17 (a) build it (the params from the
    same seeded generator on the card, the launcher's first batch), bound
    to this process's position, one ``make_tp_train_step`` step and, with
    ``retime``, a second one timed (else the first's ms). Returns the loss, launches, counted bytes (the
    world's mean), held and rule-table bytes, ms, peak memory, and on rank
    0 the gathered first moment on the host."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config, train_policy
    from repro_torch.distributed import process_group as pg
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.model_factory import build_model
    from repro_torch.train.step import TrainConfig, init_opt_state, make_tp_train_step

    _child_flags()
    dev = pg.device()
    arch, layers, batch, seq = TP_LM_CASE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg, train_policy())
    mesh = pg.bind(DeviceMesh(np.full(mesh_shape, dev, dtype=object), ("data", "model")))
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = init_opt_state(params)
    rule, rule_opt = _rule_bytes(mesh, params), _rule_bytes(mesh, opt)
    sp, so = sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh)
    del params, opt
    torch.cuda.empty_cache()
    b0 = _lm_batch(dev, cfg, batch, seq)
    step = make_tp_train_step(model, TrainConfig(), mesh)
    tp.reset_bytes()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    (_, new_o, m), first_ms = _timed(lambda: step(sp, so, b0))
    launches, counted = dict(ops.LAUNCHES), dict(tp.BYTES)
    peak = torch.cuda.max_memory_allocated(dev)
    mu = sharding.gather_params(sharding.Shards(
        [o["adam"]["mu"] for o in new_o], new_o.specs["adam"]["mu"], mesh), mesh)
    mu = _host(mu) if pg.rank() == 0 else None
    del new_o
    torch.cuda.empty_cache()
    ms = events_ms(lambda: step(sp, so, b0), reps=1, warm=False) if retime else first_ms
    return {"rank": pg.rank(), "backend": pg.backend(), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "launches": launches, "counted": counted,
            "held": _nbytes(sp[0]), "held_opt": _nbytes(so[0]), "rule": rule,
            "rule_opt": rule_opt, "first_ms": first_ms, "ms": ms, "peak": peak,
            "mu": mu}


def _bnn_dp_run(dev, mesh, steps: int) -> dict:
    """Phase 10's sign-SGD DP step on ``mesh`` (lockstep, or bound to this
    process's position), ``steps`` steps from phase 10's init and stream,
    the running BN statistics updated as phase 10 updates them: params,
    residual rows and each step's metrics on the host, launches, ms a
    step."""
    from repro_torch import tree
    from repro_torch.core.bnn import init_bnn_params, update_bn_stats
    from repro_torch.data.pipeline import DataConfig, cifar_batch_at
    from repro_torch.kernels import ops
    from repro_torch.train.bnn_trainer import (BNNTrainerConfig, _BNNTask,
                                               bnn_clip_predicate,
                                               init_dp_error_feedback,
                                               make_dp_train_step)
    from repro_torch.train.step import init_opt_state

    cfg = BNNTrainerConfig(steps=DP_STEPS)
    step = make_dp_train_step(_BNNTask(cfg.model_config()), cfg.train_config(), mesh,
                              grad_compression="signsgd",
                              clip_predicate=bnn_clip_predicate)
    rows = 1 if mesh.position is not None else len(mesh)
    params = init_bnn_params(cfg.seed, device=dev)
    state = [params, init_opt_state(params), init_dp_error_feedback(params, rows)]
    data_cfg = DataConfig(seed=cfg.data_seed, global_batch=cfg.batch)
    feeds = [{k: cifar_batch_at(data_cfg, i)[k].to(dev) for k in ("images", "labels")}
             for i in range(steps)]
    ops.reset_launches()
    metrics = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for feed in feeds:
        p, o, e, m = step(*state, feed)
        state = [update_bn_stats(p, m.pop("bn_stats"), momentum=cfg.bn_momentum), o, e]
        metrics.append(_host(m))
    torch.cuda.synchronize()
    return {"params": _host(state[0]), "err": _host(state[2]), "metrics": metrics,
            "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
            "ms": (time.monotonic() - t0) * 1e3 / steps}


def _spmd_pair() -> dict:
    """Phase 18 (a) then (c), in one process of a world of two."""
    from repro_torch.distributed import process_group as pg
    from repro_torch.launch.mesh import ServingMesh

    out = {"tp": _spmd_tp_step((1, SPMD_RANKS), True)}
    torch.cuda.empty_cache()
    _child_flags()
    dev = pg.device()
    out["bnn"] = _bnn_dp_run(dev, pg.bind(ServingMesh(tuple(pg.world_devices()))),
                             SPMD_BNN_STEPS)
    out["bnn"]["rank"] = pg.rank()
    return out


def _nccl_alone() -> dict:
    """Phase 18 (d), in a world of one under NCCL: the BNN's DP step over
    the one-process mesh (its gradient gathered through NCCL) against
    ``make_train_step``, three steps bit for bit, as phase 10 (a) holds
    the one-shard lockstep step."""
    from repro_torch import tree
    from repro_torch.core.bnn import init_bnn_params
    from repro_torch.data.pipeline import DataConfig, cifar_batch_at
    from repro_torch.distributed import process_group as pg
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.train.bnn_trainer import (BNNTrainerConfig, _BNNTask,
                                               bnn_clip_predicate,
                                               init_dp_error_feedback,
                                               make_dp_train_step)
    from repro_torch.train.step import init_opt_state, make_train_step

    _child_flags()
    dev = pg.device()
    cfg = BNNTrainerConfig(steps=DP_STEPS)
    task, tcfg = _BNNTask(cfg.model_config()), cfg.train_config()
    single = make_train_step(task, tcfg, clip_predicate=bnn_clip_predicate)
    one = make_dp_train_step(task, tcfg, pg.bind(ServingMesh((dev,))),
                             grad_compression="none", clip_predicate=bnn_clip_predicate)
    params = init_bnn_params(cfg.seed, device=dev)
    a = (params, init_opt_state(params))
    b = (*a, init_dp_error_feedback(params, 1))
    data_cfg = DataConfig(seed=cfg.data_seed, global_batch=cfg.batch)
    differ = []
    for i in range(3):
        feed = {k: cifar_batch_at(data_cfg, i)[k].to(dev) for k in ("images", "labels")}
        pa, oa, ma = single(*a, feed)
        pb, ob, eb, mb = one(*b, feed)
        differ += [(i, "/".join(map(str, path))) for (path, x), y in zip(
            tree.leaves_with_path((pa, oa, ma)), tree.leaves((pb, ob, mb)))
            if not torch.equal(x, y)]
        a, b = (pa, oa), (pb, ob, eb)
    return {"backend": pg.backend(), "world": pg.world_size(), "differ": differ}


def _coll_gap(counted: dict, reckoned: dict) -> float:
    """The worst relative gap of ``counted`` (``tensor_parallel.BYTES``)
    summed by kind and direction from a phase's ``reckoned`` bytes."""
    got = _by_kind_direction(counted)
    keys = sorted(k for k in set(got) | set(reckoned) if got[k] or reckoned.get(k))
    return max(abs(got[k] - reckoned.get(k, 0)) / max(got[k], reckoned.get(k, 0))
               for k in keys)


def _max_diff(got, want) -> float:
    from repro_torch import tree
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(tree.leaves(got), tree.leaves(want)))


def _hold_spmd_tp(label: str, card: str, ranks: list, ref: dict, reckoned: dict) -> dict:
    """Phase 18's checks of (a) / (b): every process on gloo; the loss
    within ``LM_LOSS_TOL`` of the single-device step's; the gathered first
    moment within the bf16 ``LM_GRAD_TOL`` of the single step's, its
    largest difference from the lockstep step's printed (0 expected); the
    flash launches of each process the single device's; each process's
    param and optimizer bytes the rule table's; the counted bytes (the
    world's mean) the reckoning. Prints ms a step and peak memory per
    process."""
    mu = ranks[0]["mu"]
    rel = _leaf_rel_l2(mu, ref["mu_one"])
    worst = max(rel, key=rel.get)
    diff = _max_diff(mu, ref["mu"])
    res = {"backend": sorted({r["backend"] for r in ranks}),
           "loss": [r["loss"] for r in ranks], "loss_lockstep": ref["loss"],
           "loss_single": ref["loss_one"], "max_diff_from_lockstep": diff,
           "loss_diff_from_lockstep": max(abs(r["loss"] - ref["loss"]) for r in ranks),
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "launches": [{k: v for k, v in r["launches"].items() if v} for r in ranks],
           "held_bytes": [r["held"] for r in ranks], "rule_bytes": ranks[0]["rule"],
           "held_opt_bytes": [r["held_opt"] for r in ranks],
           "rule_opt_bytes": ranks[0]["rule_opt"],
           "collective_gap": max(_coll_gap(r["counted"], reckoned) for r in ranks),
           "collective_bytes_counted": {f"{k} {s} {d}": n for (k, s, d), n in
                                        sorted(ranks[0]["counted"].items())},
           "ms": [r["ms"] for r in ranks], "first_ms": [r["first_ms"] for r in ranks],
           "peak_bytes": [r["peak"] for r in ranks]}
    print(f"  {label}: {len(ranks)} processes on {res['backend']}, loss {res['loss'][0]:.6f} "
          f"(lockstep {ref['loss']:.6f}, single device {ref['loss_one']:.6f}); gathered "
          f"gradients: largest difference from the lockstep step {diff:.3g}, per-leaf rel "
          f"L2 from the single step max {rel[worst]:.3g} ({worst}); launches per process "
          f"{res['launches']}; param bytes {res['held_bytes']} (rule table "
          f"{res['rule_bytes']}); counted collective bytes against the reckoning: worst "
          f"gap {res['collective_gap']:.3g}; a step {res['ms']} ms per process (CUDA "
          f"events; first call {[round(x, 1) for x in res['first_ms']]}), peak "
          f"{[round(p / 2**30, 2) for p in res['peak_bytes']]} GiB [{card}]", flush=True)
    if res["backend"] != ["gloo"]:
        fail(f"{label}: ranks sharing the card ran on {res['backend']}, not gloo")
    for r in ranks:
        if not abs(r["loss"] - ref["loss_one"]) <= LM_LOSS_TOL:
            fail(f"{label}: rank {r['rank']} loss {r['loss']} vs single {ref['loss_one']}")
        for name in ("flash_attention", "flash_attention_bwd"):
            if not ref["one"][name] or r["launches"][name] != ref["one"][name]:
                fail(f"{label}: rank {r['rank']} launched {name} {r['launches'][name]} "
                     f"times, the single device {ref['one'][name]}")
        if r["held"] != r["rule"] or r["held_opt"] != r["rule_opt"]:
            fail(f"{label}: rank {r['rank']} holds {r['held']} / {r['held_opt']} param / "
                 f"optimizer bytes, the rule table's {r['rule']} / {r['rule_opt']}")
    if rel[worst] > LM_GRAD_TOL["bfloat16"]:
        fail(f"{label}: gathered gradient {worst} rel L2 {rel[worst]:.3g} > "
             f"{LM_GRAD_TOL['bfloat16']} of the single-device step's")
    if res["collective_gap"] > 1e-9:
        fail(f"{label}: counted collective bytes are not the reckoning {reckoned}")
    return res


def spmd_phase(dev, card: str, tp_run: dict, fsdp: dict) -> dict:
    """Phase 18: the training steps one process a device
    (``distributed.process_group``), processes spawned with
    ``torch.multiprocessing`` meeting through a ``file://`` store under
    ``build/spmd``; the kernels are built already (phase 3). (a) phase 14's
    step on (1, 2) in two processes sharing the card over gloo, (c) phase
    10's sign-SGD DP step in the same two, while (d) a world of one runs on
    NCCL beside them and this process runs (c)'s lockstep step; then (b)
    phase 17 (a)'s step on (2, 2) in four. The layout rule's refusal of
    NCCL for two ranks on the one card comes first. The processes'
    launches, summed, are the path ``lm_spmd_train``."""
    import concurrent.futures

    from repro_torch.distributed import process_group as pg
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ServingMesh

    t0 = time.monotonic()
    work = OUT_DIR / "spmd"
    work.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()
    res, seconds = {}, {}
    launches = {name: 0 for name in ops.LAUNCHES}

    def run(part: str, call):
        try:
            return call()
        except Exception as e:  # a child's failure fails the run
            fail(f"phase 18 ({part}): {type(e).__name__}: {e}")

    try:
        pg.backend_for([dev, dev], "nccl")
        fail("phase 18 (d): NCCL for two ranks on one card was not refused")
    except ValueError as e:
        res["nccl_refusal"] = str(e)
    print(f"  (d) the layout rule refuses NCCL for two ranks on the card: "
          f"{res['nccl_refusal']}", flush=True)

    t = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        pair = ex.submit(pg.spawn, _spmd_pair, SPMD_RANKS, workdir=str(work))
        alone = ex.submit(pg.spawn, _nccl_alone, 1, backend="nccl", workdir=str(work))
        lock = _bnn_dp_run(dev, ServingMesh((dev,) * SPMD_RANKS), SPMD_BNN_STEPS)
        pair, (alone,) = run("a, c", pair.result), run("d", alone.result)
    seconds["a, c, d"] = time.monotonic() - t
    arch, layers, batch, seq = TP_LM_CASE
    res["a"] = _hold_spmd_tp(
        f"(a) {arch} ({layers} of its layers) batch {batch} x {seq} bf16 on (1, "
        f"{SPMD_RANKS}), one process a rank", card, [p["tp"] for p in pair],
        LOCKSTEP.pop("tp"), tp_run["collectives"]["reckoned"])
    for p in pair:
        for name, n in p["tp"]["launches"].items():
            launches[name] += n

    spmd_bnn = [p["bnn"] for p in pair]
    differ = []
    for r in spmd_bnn:
        k = r["rank"]
        for name, got, want in (("params", r["params"], lock["params"]),
                                ("err", r["err"], _rows_of(lock["err"], k)),
                                ("metrics", r["metrics"], lock["metrics"])):
            if not _identical(got, want):
                differ.append(f"rank {k} {name}")
        for name, n in r["launches"].items():
            launches[name] += n
    res["c"] = {"steps": SPMD_BNN_STEPS, "differ": differ,
                "ms": [r["ms"] for r in spmd_bnn], "lockstep_ms": lock["ms"],
                "launches": [r["launches"] for r in spmd_bnn],
                "lockstep_launches": lock["launches"],
                "loss": [float(m["loss"]) for m in lock["metrics"]]}
    print(f"  (c) the BNN's sign-SGD DP step, {SPMD_BNN_STEPS} steps in {SPMD_RANKS} "
          f"processes sharing the card over gloo against phase 10's lockstep step on "
          f"{SPMD_RANKS} replicas: params, residual rows and metrics "
          f"{'bit-identical' if not differ else 'DIFFER: ' + ', '.join(differ)}; losses "
          f"{res['c']['loss']}; {res['c']['ms']} ms a step per process (host clock), "
          f"{lock['ms']:.1f} ms lockstep; launches per process {res['c']['launches']} "
          f"(lockstep {lock['launches']}) [{card}]", flush=True)
    if differ:
        fail(f"phase 18 (c): SPMD BNN DP step differs from the lockstep one: {differ}")
    del pair, spmd_bnn, lock
    torch.cuda.empty_cache()

    t = time.monotonic()
    quad = run("b", lambda: pg.spawn(_spmd_tp_step, math.prod(FSDP_MESH), FSDP_MESH,
                                     False, workdir=str(work)))
    seconds["b"] = time.monotonic() - t
    res["b"] = _hold_spmd_tp(
        f"(b) {arch} ({layers} of its layers) batch {batch} x {seq} bf16 on "
        f"{FSDP_MESH}, one process a device", card, quad, LOCKSTEP.pop("fsdp"),
        fsdp["parts"]["a"]["collectives"]["reckoned"])
    for q in quad:
        for name, n in q["launches"].items():
            launches[name] += n
    del quad

    res["d"] = alone
    print(f"  (d) a world of one on {alone['backend']}: the BNN DP step over it against "
          f"make_train_step, 3 steps: "
          f"{'bit-identical' if not alone['differ'] else alone['differ'][:5]}", flush=True)
    if alone["backend"] != "nccl" or alone["differ"]:
        fail(f"phase 18 (d): {alone}")
    res.update(launches=launches, part_seconds=seconds, seconds=time.monotonic() - t0)
    print(f"  phase 18 parts {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())} s; "
          f"{res['seconds']:.1f} s in all", flush=True)
    return res


def _rows_of(err, k: int):
    from repro_torch import tree
    return tree.tree_map(lambda t: t[k:k + 1], err)


def _identical(a, b) -> bool:
    from repro_torch import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


KERNELS = {
    "xnor_gemm": ("src/repro_torch/kernels/csrc/xnor_gemm.cu",
                  "src/repro/kernels/xnor_gemm.py:105"),
    "fused_xnor_gemm": ("src/repro_torch/kernels/csrc/fused_gemm.cu",
                        "src/repro/kernels/fused_gemm.py:125"),
    "fused_direct_conv": ("src/repro_torch/kernels/csrc/direct_conv.cu",
                          "src/repro/kernels/direct_conv.py:171"),
    "megakernel_conv_stage": (
        "src/repro_torch/kernels/csrc/megakernel_conv_stage.cu",
        "src/repro/kernels/megakernel.py:339"),
    "megakernel_chain": ("src/repro_torch/kernels/csrc/megakernel_chain.cu",
                         "src/repro/kernels/megakernel.py:229"),
    "pack_rows": ("src/repro_torch/kernels/csrc/pack_rows.cu",
                  "src/repro/kernels/pack.py:44"),
    "direct_conv": ("src/repro_torch/kernels/csrc/direct_conv.cu",
                    "src/repro/kernels/direct_conv.py:235"),
    "unpack_gemm": ("src/repro_torch/kernels/csrc/unpack_gemm.cu",
                    "src/repro/kernels/unpack_gemm.py:74"),
    "ssm_scan_chunk": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                       "src/repro/kernels/ssm_scan.py:70"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:102"),
    "mlstm_chunked": ("src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                      "src/repro/kernels/mlstm_chunk.py:112"),
    # the backward kernels have no Pallas original: each names the JAX
    # function whose jax.grad it computes
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:84"),
    "ssm_scan_chunk_bwd": ("src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                           "src/repro/models/mamba.py:67"),
    "mlstm_chunked_bwd": ("src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                          "src/repro/models/xlstm.py:49"),
}


class PhaseClock:
    """Seconds of each phase on the host clock, printed as it ends."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._t = time.monotonic()

    def done(self, phase: str) -> None:
        now = time.monotonic()
        self.seconds[phase] = now - self._t
        self._t = now
        print(f"  phase {phase}: {self.seconds[phase]:.1f} s", flush=True)


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from repro_torch.configs.bnn_cifar import BNNExperiment
        from repro_torch.kernels import build, ops
    except ImportError as err:
        fail(f"cannot import the port from {ROOT / 'src'}: {err}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    start = time.monotonic()
    loop_procs = start_xnor_loop_build()
    info = build.build()
    print(f"kernel build: {info['seconds']:.1f} s ({', '.join(info['built']) or 'cached'})"
          f" in {info['dir']}", flush=True)
    for name, log in info["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    clock = PhaseClock()
    print("phase 3: the packed product's inner loops, then kernels vs plain "
          "twins at their main paths' shapes (bit-exact)", flush=True)
    xnor_loops = xnor_loop_rates(loop_procs)
    # The Table 2 forward's own shapes (its batch) make the totals of its
    # kernels; the batch-32 shapes are checked and timed beside them.
    paper_batch = BNNExperiment("table2").batch
    totals, rows = kernel_phase(dev, paper_batch)
    megakernel_phase(dev, totals, rows)
    unfused_kernel_phase(dev, totals, rows, paper_batch, summed=True)
    unfused_kernel_phase(dev, totals, rows, BATCH, summed=False)
    unpack_decode_phase(dev, totals, rows)
    scan_phase(dev, totals, rows)
    attention_phase(dev, totals, rows)
    clock.done("3")
    print("phase 4: serving on the trained checkpoint", flush=True)
    serve = serve_phase(dev)
    from repro_torch.core.bnn import (load_binary_checkpoint,
                                      pack_bnn_params_fused,
                                      pack_bnn_params_megakernel)
    latent = load_binary_checkpoint(CKPT, device=dev)
    packed = pack_bnn_params_fused(latent)
    mega = pack_bnn_params_megakernel(latent)
    print("phase 4a: every executor's CUDA graph against its eager forward",
          flush=True)
    serve["first_conv"] = first_conv_invariance(dev, packed)
    serve["graphs"] = graph_phase(dev, packed, mega)
    print("phase 4b: every kernel tiling against the twins, and the tuner",
          flush=True)
    serve["tilings"] = tiling_phase(dev, paper_batch, packed, mega)
    print(f"phase 4c: load runs ({LOAD_RATE:.0f} requests/s for "
          f"{LOAD_SECONDS:.0f} s)", flush=True)
    serve["load"] = load_phase()
    print(f"phase 4d: a request of {BATCH} images through the engine",
          flush=True)
    serve.update(engine_latency(dev, packed, mega))
    for name, fwd in (("xnor_direct", "xnor_direct"),
                      ("megakernel", "megakernel_stages")):
        print(f"  batch {BATCH} {name}: {serve[f'engine_b32_{name}_ms']:.3f} ms "
              f"through the engine (graphs, submit to logits on the host), "
              f"{serve[f'forward_b{BATCH}_{fwd}_ms']:.3f} ms eager forward, "
              f"{serve[f'forward_b{BATCH}_{fwd}_graph_ms']:.3f} ms graph "
              "replay alone", flush=True)
    clock.done("4")
    print("phase 5: Table 2 on the card", flush=True)
    table2 = table2_phase(dev)
    clock.done("5")
    print("phase 6: jamba-1.5-large-398b, one full-width period, served "
          "from 1-bit weights", flush=True)
    jamba = jamba_phase(dev)
    clock.done("6")
    print("phase 7: LM training forward (Model.loss) at full width",
          flush=True)
    lm = lm_phase(dev)
    clock.done("7")
    print("phase 8: the BNN trained, resumed, exported and served on the card",
          flush=True)
    train = train_phase(dev)
    clock.done("8")
    print("phase 9: the BNN served over a mesh of replicas, with a device "
          "loss and a silent heartbeat", flush=True)
    mesh = mesh_phase(dev)
    clock.done("9")
    print("phase 10: the BNN trained over a mesh of replicas, under chaos, "
          "and exported", flush=True)
    resilient = train_resilient_phase(dev)
    clock.done("10")
    print("phase 11: the LM trainer: the backward kernels against their "
          "twins, then smollm-360m and xlstm-1.3b trained at full width, the "
          "smoke families and a resume through the launcher", flush=True)
    lm_bwd_kernel_phase(dev, totals, rows)
    lm_train = lm_train_phase(dev)
    clock.done("11")
    print("phase 12: the remaining LM families: seven served at full width "
          "from 1-bit weights, seamless-m4t-large-v2 and pixtral-12b trained, "
          "the smoke configs", flush=True)
    families = families_phase(dev)
    clock.done("12")
    print("phase 13: the dry run's op counter on the card and on meta, and "
          "smollm-360m trained data-parallel on replicas sharing the card",
          flush=True)
    dryrun_dp = dryrun_dp_phase(dev, smi)
    clock.done("13")
    print("phase 14: qwen2.5-3b trained tensor-parallel over a (1, 2) mesh of "
          "ranks sharing the card, against the single-device step", flush=True)
    tp_run = tp_phase(dev, smi)
    clock.done("14")
    print("phase 15: moonshot-v1-16b-a3b trained expert-parallel over a (1, 2) "
          "mesh of ranks sharing the card, against the single-device step; "
          "arctic's smoke config beside it", flush=True)
    ep_run = ep_phase(dev, smi)
    clock.done("15")
    print("phase 16: jamba's mamba block, jamba's smoke config, xlstm-1.3b and "
          "seamless-m4t-large-v2 trained tensor-parallel over a (1, 2) mesh of "
          "ranks sharing the card, against one device", flush=True)
    ssm_tp = ssm_tp_phase(dev, smi)
    clock.done("16")
    print("phase 17: qwen2.5-3b and jamba's smoke config trained fully sharded over "
          "a (2, 2) mesh of ranks sharing the card, against the single-device step",
          flush=True)
    fsdp = fsdp_phase(dev, smi, tp_run)
    clock.done("17")
    print("phase 18: one process a device: qwen2.5-3b's TP and FSDP steps and the "
          "BNN's sign-SGD DP step in processes sharing the card over gloo, against "
          "the lockstep steps; a world of one on NCCL", flush=True)
    spmd = spmd_phase(dev, smi, tp_run, fsdp)
    clock.done("18")
    jamba_launches = dict(jamba["launches"]["prefill"])
    for counts in jamba["launches"]["decode"]:
        for name, n in counts.items():
            jamba_launches[name] += n
    launches = {**serve["launches"], **table2["launches"],
                "jamba_serve": jamba_launches,
                **{f"{arch}_loss": r["launches"] for arch, r in lm.items()},
                "bnn_train_export": train["launches"],
                "bnn_serve_mesh": mesh["launches"],
                "bnn_train_resilient": resilient["launches"],
                "lm_train": lm_train["launches"], **families["launches"],
                "lm_dp_train": dryrun_dp["launches"],
                "lm_tp_train": tp_run["launches"],
                "lm_ep_train": ep_run["launches"],
                "lm_tp_ssm_train": ssm_tp["launches"],
                "lm_fsdp_train": fsdp["launches"],
                "lm_spmd_train": spmd["launches"]}
    for name in KERNELS:
        if not sum(path[name] for path in launches.values()):
            fail(f"kernel {name} was not launched on the main path")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": info["seconds"], "xnor_loops": xnor_loops, "shapes": rows,
         "serve": serve,
         "table2": table2, "jamba": jamba, "lm_loss": lm, "train": train,
         "mesh": mesh, "train_resilient": resilient, "lm_train": lm_train,
         "families": families, "dryrun_dp": dryrun_dp, "tp": tp_run,
         "ep": ep_run, "ssm_tp": ssm_tp, "fsdp": fsdp, "spmd": spmd,
         "totals": totals,
         "phase_seconds": clock.seconds},
        indent=2))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S
        t_ops = t["ops"] / OPS_RATE.get(name, B1_OPS_PER_S)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p[name] for p in launches.values()),
            # the families' paths stand in the flash rows even at 0 (no
            # kernel serves them)
            "launches_by_path": {path: p[name] for path, p in launches.items()
                                 if p[name] or (name.startswith("flash")
                                                and path in families["launches"])},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"],
        })
        for extra in ("per_layer_ms", "real_input_max_abs_err",
                      "fp32_bound_ms", "tc_bound_ms",
                      "library_bf16_ms", "served_head_ms"):
            if extra in t:
                kernels[-1][extra] = t[extra]
    print(f"chip_smoke: {time.monotonic() - start:.1f} s in all (phases "
          + ", ".join(f"{k} {v:.1f}" for k, v in clock.seconds.items()) + " s)",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
