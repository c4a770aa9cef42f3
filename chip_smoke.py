#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which fails the run on error:

1. build   — compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source, in
             parallel) and print the build seconds and ptxas report (a
             ``flash_fwd_hopper`` or ``qmm_hopper`` with a stack frame or
             spills fails the run).
2. kernels — every kernel against its plain PyTorch version on the card at
             the main path's shapes: the packed OTA superpose/fold over every
             storage class, per-row and blockwise scales, gains absent and
             present, K_g in {1, 7, 20}, M = the DeepSpeech2 layout
             (4,134,912); the cosine top-k over f32 and int8 slabs with
             n < Np, duplicate records (exact ties) and k = 32. Kernels and
             plain versions do the same f32 ops in the same order, so the
             tolerance is exact equality (max_abs_err 0, equal indices).
             Prints each kernel's time (CUDA events, median of 20), the
             plain version's, the bound and, where one PyTorch call computes
             the same function, that call's (library_ms).
3. rounds  — two ``FLServer`` rounds at the full DeepSpeech2 width (20
             clients, 20 per round, default local steps/batch, RAG planner,
             quant_block 256, FedAvgM 0.9 with a bf16 velocity), with the
             launch counters zeroed just before
             and read just after; every kernel must have launched. The
             round's packed rows are re-aggregated with the plain versions on
             the card and must match the kernel path exactly; the byte
             accounting must match the wire format; params must be finite.
             Then, on the last round's own inputs, the superpose, the folds
             and the planner's top-k (bit for bit against its plain
             version) are timed one call (``ms``, host work included) and
             ten queued (``ms_queued``, device time), and the engine's
             ``retrieval.query`` is split into the slab's upload, the
             queries' upload, the kernel call and the copy back.
   state   — on the rounds' server (``--phases build,rounds,state``): its
             params and bf16 FedAvgM velocity saved through
             ``ckpt.CheckpointManager(keep=2)`` at steps 1-3 (step 1 must be
             gone, the restore on the card bit for bit; codec flag, file
             and raw bytes, save and load ms); the planner's feedback
             database saved and restored into a fresh one on the card, whose
             queries (through the top-k kernel, counters zeroed just before)
             must equal the saved one's bit for bit; the per-tree oracle
             ``ota.ota_aggregate_pertree`` against the flat path (row 4) on
             20 seeded updates of the server's layout at bits 4/8/16/32 with
             the same ``TorchRoundDraws`` (participation equal, noise_std
             within 1e-6, leaves within rtol 1e-4 / atol 1e-5, the
             reference's tolerance for the same comparison), both timed; the
             uplink API on one row at 4, 8 and 16 bits (blockwise scales:
             error within one scale up to f32 rounding, ``wire_nbytes`` ==
             ``packing.row_wire_bytes``) and ``digital_uplink_bits``; and the
             rounds' spans and metrics through ``obs.export.dump_telemetry``
             (every JSONL line parses, the Perfetto trace names every round
             stage).
   mesh    — the sharded data planes on one card (``launch.mesh.DataMesh``
             of n shards all on it; ``--phases build,rounds,mesh``), every
             result bit for bit the unsharded kernel path's, with the row
             1-3 counters zeroed just before each sharded call and read just
             after: each barrier round's rows aggregated again through
             ``ota_aggregate_packed(mesh=)`` at 4 shards (chunks of
             1,033,728 symbols) and 5 (827,136, 768 padded) with the round's
             own weights and draws (superpose/fold launches exactly shards x
             groups; aggregate and fold timed beside the unsharded ones;
             the unsharded aggregate also the plain versions'); a fading
             ``StreamingFLServer`` round on a 4-shard mesh (an on-time and
             a late wave, staleness and gains) and its waves folded again
             through ``OtaAccumulator(mesh=)`` at 4 and 5, all bit for bit
             the plain versions' refold; one round of a fresh ``FLServer``
             with ``mesh_data_shards`` 4 and a 4-shard mesh on the card
             (bytes as the wire format, params finite, its aggregate the
             unsharded aggregation of its own rows; the knob alone spans
             four distinct cards and must raise on one);
             ``ops.topk_cosine_sharded`` and ``RetrievalEngine(mesh=)`` on
             4 shards over a 262,144-record arena of the planner's width
             (f32 and int8, 1,000 records of padding, triplicated records,
             k 32 and 128; one launch a shard), bit for bit the unsharded
             kernel and ``topk_plain``, row 3 timed there beside its bound
             and its plain version; each shard's ``shard_nbytes``.

4. flat    — the one-shot f32 aggregation (``ota.ota_aggregate`` on update
             trees): K = 20 DeepSpeech2-shaped f32 trees (full width, seeded,
             values x 0.01) at the bits of the last barrier round with one
             row forced to 32 bits, through the in-pass quantize-superpose
             kernel, counters zeroed just before and read just after. The
             kernel is held against its plain version on the same inputs
             (aggregate exact; sum of squares within rtol 1e-5, and equal
             across two launches) and timed beside its plain version, its
             bound and ``torch.mv`` (the one library call for the all-32-bit
             case).
5. stream  — two ``StreamingFLServer`` rounds at full DeepSpeech2 width on
             the fading channel (20 clients a round, fill 0.7, grace 8 s,
             ``LatencyModel.with_tail(5.0)``, local_steps 1): each round has
             an on-time wave, a late wave and lost rows. Per round the waves
             are re-folded with the plain versions (exact), the counted rows
             folded as one wave must equal ``ota_aggregate_packed``'s
             pre-noise aggregate for the same draws and gains (exact), and
             the superpose/fold launches must rise by the counts the waves'
             storage groups imply.

6. ops     — the kernel entry points ``repro_torch.kernels.ops`` at the
             repository's model widths, counters zeroed just before and read
             just after: ``fake_quant`` on every leaf of a full-width
             DeepSpeech2 update (4,133,952 f32 params) at 4, 8 and 16 bits,
             nearest and stochastic (seeded generator), and on a Qwen3-8B
             w_gate (4,096 x 12,288 bf16) at 8 bits; ``ota_aggregate`` of K =
             20 DeepSpeech2 rows (FedAvg weights, seeded noise, std 0.1);
             ``qmatmul`` on the int8 (``quantize_weights``) w_gate and w_down
             with bf16 x at M = 4, 8,192 and 1,000 (the last two on the
             Hopper route) and f32 x at M = 4 and 1,000, each printed with
             its ``design``, launched twice (the same bits) and timed one
             call (``ms``) and ten queued (``ms_queued``) beside
             ``torch.matmul`` both ways, with TFLOP/s and the share of the
             bound; the C launcher's route table against ``kernel_design``;
             ``qmatmul_int4`` at w_gate, M = 4; ``pack_int4_rows`` /
             ``unpack_int4_rows``, ``ota_dequant_superpose`` and
             ``ota_fold_packed`` on K = 20 int4 DeepSpeech2 rows (blockwise
             scales, gains); ``topk_cosine`` (int8 slab, k = 128);
             ``flash_mha(q, k, v, causal=...)`` at OPS_FLASH_CASES (the
             zamba2, kimi-k2, whisper widths, non-causal, Sq > Sk, D = 32
             and a zero-padded D = 40); ``ota_quantize_superpose`` at K =
             4,001 and 8,000 rows of 262,144 (one launch per 4,000 rows);
             ``RetrievalEngine.topk`` at k = 300 (past the kernel's limit)
             on an engine whose slab is on the card. Fake-quant, the
             aggregate, the packed superpose/fold, the top-k and the
             quantize-superpose must equal their plain versions exactly, the
             matrix product within ``kernels/qmatmul.mismatch``'s rule, the
             attention within ``kernels/flash_attention.mismatch``'s. Each
             kernel is timed beside its plain version, its bound and a library
             call (``library_ms``, timed only).
7. host    — each kernel wrapper's host microseconds a call on ~1,024
             elements (the least of 5 loops of 1,000 calls), beside one
             PyTorch call for the same function where there is one.
8. serve   — Qwen3-8B at full width (36 layers, d_model 4,096, 32/8 heads
             of 128, vocab 151,936, bf16, random weights from a seed) through
             ``launch.serve.serve`` with ``use_flash_kernel``: 4 prompts of
             2,048 tokens, prefill (the flash counter must rise by exactly 36),
             the cache grown to 2,080, 31 greedy decode steps (logits finite);
             the same prefill through the plain ``chunked_attention``
             (log-softmax within SERVE_LOGIT_TOL); the sharded prefill and
             decode (``launch.steps.make_sharded_prefill_step`` /
             ``make_sharded_decode_step``, SERVE_SHARDED) on (2, 2) meshes
             of four shards of the card by both routes and on (1, 4)
             tensor-parallel, the params placed by the specs, 31 decode
             steps fed the unsharded run's greedy tokens: each step's
             log-softmax within TP_SERVE_LOGIT_TOL of the unsharded one's,
             the cache ``cache_spec``'s pieces a device written in place,
             row 7 on each model shard's heads (36 x M launches a
             prefill), prefill and decode ms, the params' bytes each step
             gathers; the planted dropped partial must break the bound, and
             on (2, 1) the routes are bit for bit; qwen2-vl-2b on (1, 4)
             (2 kv heads over 4 shards: a replicated cache, every replica
             equal); ``ServeEngine`` on the same params (max_batch 4,
             cache_len 256) draining 8 requests; then falcon-mamba-7b,
             zamba2-2.7b and whisper-tiny at full width and depth
             (TP_FAMILIES: 256-token prompts, the Mamba blocks split by
             channel or head) the same way without the (2, 1) check,
             within TP_FAM_SERVE_LOGIT_TOL, only the leaves TP_FAM_COPIES
             names read into copies.
   families — the moe, vlm, ssm, hybrid and audio families at full width through
             the same entry points, one config at a time (the previous one's
             params freed), bf16, random weights from a seed,
             ``use_flash_kernel``: kimi-k2-1t-a32b at 1 of 61 layers
             (19,378,623,488 params: 384 experts of 2,048, top 8, 64/8 heads
             of 112 on the mma.sync flash route), arctic-480b at 2 of 35
             (27,681,131,520: 128 experts of 4,864, top 2, a dense residual
             MLP, 56/8 heads of 128), and at full depth qwen2-vl-2b
             (1,779,447,296: M-RoPE, 8 zero patch embeddings ahead of the
             prompt, 12/2 heads of 128), falcon-mamba-7b (7,272,665,088:
             64 Mamba-1 layers, d_inner 8,192, state 16, no attention) and
             zamba2-2.7b (2,435,777,440: 54 Mamba-2 layers of 80 SSD heads
             of 64, state 64, and one shared attention + MLP block, 32/32
             heads of 80 on the mma.sync route, after every 6 of them) and
             whisper-tiny (61,221,888: 4 encoder layers over 1,500 frames
             of 384 a request, drawn after the prompts, and 4 decoder
             layers, 6/6 heads of 64 on the Hopper flash route, sinusoidal
             positions). Per config: the param count and bytes, the init's seconds and
             peak (at most the params' bytes + 4 GiB: leaves are drawn a
             slab at a time; for ssm and hybrid A_log, D and dt_bias must
             be f32); ``launch.serve.serve`` on 4 prompts of 2,048 tokens
             with 32 generated (the flash counter must rise by exactly one
             launch an attention layer: n_layers, 0 for falcon-mamba, 9
             shared-block applications for zamba2, 4 decoder layers for
             whisper; logits finite, ids in the vocabulary); for whisper
             the prefill's encoder and decoder timed apart beside their
             bounds, the encoder's output held to the cached ``enc_out``; for ssm and hybrid layer 0's chunked scan on the
             prefill's own inputs against its step-by-step recurrence (y and
             the final state within rtol/atol 1e-4, the reference tests'
             tolerance), each scan timed and its share of the prefill and of
             a decode step; flash against chunked prefill (none for
             falcon-mamba; for qwen2-vl, zamba2 and whisper the serve
             phase's check;
             for the MoE configs each layer's attention output against
             ``chunked_attention`` on the prefill's own q, k, v within
             ``flash_attention.mismatch``, the routing differences per
             layer, and the last-position log-softmax within
             SERVE_LOGIT_TOL on the rows whose last token routes alike);
             ``ServeEngine`` draining 8 requests (whisper's decodes against
             the all-zero ``enc_out``, as the reference's); prefill ms, decode ms a
             token, engine seconds and peak memory beside the bounds of
             ``family_bounds``.
   zoo     — the model zoo's mesh (``launch.mesh.make_mesh``,
             ``util.use_mesh``, ``launch.sharding``): kimi-k2-1t-a32b (the
             families phase's 1-layer build, the flash prefill) prefills 4
             x 2,048 tokens under a (2, 2) ("data", "model") mesh of four
             shards on the card; the MoE takes the expert-parallel branch
             (one ``moe_shard_map`` span a layer: 4,096 tokens a data shard,
             192 experts a model shard, capacity 106), the branch is held
             against ``moe_sharded_plain`` on layer 0's input (ZOO_MOE_ULPS)
             and the prefill's logits against the same prefill through the
             plain version (SERVE_LOGIT_TOL); a decode step under the mesh
             takes the local path (no span) and equals the unmeshed one
             bit for bit; the sharded, plain and unsharded blocks, the
             meshed and unmeshed prefills timed, and the dropped share of
             (token, slot) pairs on each path. Then stablelm-1.6b's params
             and AdamW moments placed on the mesh by ``tree_param_specs``:
             each device's bytes equal the specs' reckoning and what the
             allocator grew, and every leaf gathers back bit for bit.
9. train   — stablelm-1.6b at full width and depth (24 layers, d_model
             2,048, 32 heads of 64, d_ff 5,632, vocab 100,352, bf16, the
             config's remat=True, random weights from a seed) through
             ``launch.train``'s body: 6 donating AdamW steps (lr 1e-3,
             warmup 1) of 4 x 2,048 Markov tokens with f32 moments, each
             step's loss, grad norm, synchronised ms, tokens/s and host ms
             drawing the batch, the peak device memory and the step's bound
             (``train_bound_ms``); the same 6 steps without donation, whose
             state the donated one must equal bit for bit and whose peak
             the donated one must stay under; one more step split by CUDA events into
             forward+backward, clip, optimizer and update; 3 steps from the
             same params and batches with quantized moments (state <= 0.5x,
             the first loss equal bit for bit); the chunked ``lm_loss``
             against ``F.cross_entropy`` over full logits (CE_RTOL); the
             gradients at 2 layers with remat on and off (bit for bit but
             the embedding's and head's, which accumulate by index); a
             reduced run checkpointed at steps 2 and 4 and resumed to 6. No
             kernel's launch count may move.
   shardtrain — the donating sharded train step (``launch.steps.
             make_sharded_train_step(..., donate=True)``) with the train
             phase's model, seed, optimizer and batches: 3 unsharded steps (results kept on the
             host), then 3 sharded steps from the same state on a (2, 2)
             ("data", "model") mesh of four shards of the card (the AdamW
             state placed by ``tree_param_specs``, 2 x 2,048 tokens a data
             shard): each step's loss and grad norm within SHARD_LOSS_RTOL /
             SHARD_GNORM_RTOL of the unsharded one, each device's bytes the
             specs' after every step, and after step 3 the params (share of
             bf16 elements that differ, largest difference) and the f32
             moments within SHARD_* bounds read beside a planted fault (data
             shard 1's gradient dropped), which must fail them; step ms both
             ways, the sharded step split by CUDA events into placement,
             gathers, forward+backward per shard, gradient mean, clip and
             optimizer, each with the allocator's books (bytes at its
             entry, peak and exit, cudaMalloc calls, retries; the
             optimizer's peak at most the forward+backward's), the peak
             within its reckoning (``shard_reckoning``); on (2, 2), by both
             routes, the same 3 steps without donation first, every piece
             bit for bit the donated run's, their peak beside; step 2 on a (1, 1) mesh bit for bit the
             unsharded step 2 but the embedding's and head's leaves (which
             accumulate by index); one quantized-moment step on the (2, 2)
             mesh against the unsharded one; then falcon-mamba-7b (4 of
             64 layers), zamba2-2.7b (one segment) and whisper-tiny at full
             width (TP_FAM_TRAIN, 4 x 512 tokens): 3 unsharded steps, 3 by
             the gather route on (2, 2) and by the tensor-parallel route on
             (2, 2) and (1, 4) within TP_FAM_TOLS, and a planted dropped
             partial of each family's new reductions that must break them.
             No kernel's launch count may move.

The ``kernels`` phase also holds the quantize-superpose kernel against its
plain version over every width 2-31 and 32, K in {1, 7, 20}, aligned and
ragged M, and the flash kernel against its plain version at every
FLASH_CASES shape: the serve phase's (B 4, S 2,048, H 32, KV 8, D 128,
bf16), a ragged S = 2,000, StableLM-1.6B's widths (MHA, D 64), two f32
cases, and the other configs' widths and masks (zamba2-2.7b D 80,
kimi-k2-1t-a32b 64/8 heads of 112, Qwen3-8B non-causal, whisper-tiny's
encoder keys cut to a tile-aligned 1,536, causal Sq > Sk, f32 D 32, a
zero-padded D 40), the families phase's prefills at B 4, S 2,048
(kimi-k2 64/8 heads of 112, arctic 56/8 and qwen2-vl 12/2 of 128,
zamba2 32/32 of 80, whisper-tiny's decoder 6/6 of 64),
element by element and by the share of elements that
differ (``flash_attention.mismatch``; ``scripts/flash_tolerance_probe.py``
takes the readings behind its limits). It times the kernel at each case
beside its bound and ``scaled_dot_product_attention`` (``library_ms``,
timed only; causal top-left, GQA), and the plain version at the serve
shapes.

Then one JSON line ``{"kernels": [...]}`` (launches summed over the paths
that run each kernel, each path with the counters zeroed just before it),
the card's name and power limit (``nvidia-smi``), and last the device line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA card, or outside the repository, it exits non-zero and prints
no result. ``--phases build,kernels`` (or ``build,ops``) runs only the named
phases (no result lines). ``--phases build,rows`` reads rows 1-3 at the
barrier round's shapes on seeded data without training (``phase_rows``):
seconds a tree, to compare two trees in one call. ``--phases
build,trainprof`` profiles one full-width training step (``phase_trainprof``:
device busy and idle share, kernel time by class and name, the chunked
attention's share, the stacked leaves unbound against indexed);
``--phases build,shardprof`` the sharded step's data shard passes
(``phase_shardprof``: per pass device busy ms, kernel ms by class, the
matmul kernels, cudaMalloc calls, allocator retries, SM clock and power);
``--phases build,tpfamilies`` the ssm, hybrid and audio families' parts
of shardtrain and serve alone (``phase_tpfamilies``), every check read
before the run fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's rates (an H100 SXM: HBM3; f32 outside the tensor cores; dense
# bf16 on them); outside the repository this import fails, and so the run
from repro_torch.launch.mesh import CARD_BF16_FLOPS as BF16_FLOPS  # noqa: E402
from repro_torch.launch.mesh import CARD_F32_FLOPS as F32_FLOPS  # noqa: E402
from repro_torch.launch.mesh import CARD_HBM_BYTES_PER_S as HBM_BYTES_PER_S  # noqa: E402

STREAM_GRACE_S = 8.0


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after warm-up)."""
    import torch

    for _ in range(warmup):
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


# cycles of ``torch.cuda._sleep`` ahead of a queued reading (about 2 ms on
# an H100): the host enqueues the calls while the card sleeps
QUEUE_SLEEP_CYCLES = 4_000_000


def cuda_ms_queued(fn, n: int = 10, reps: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``n`` calls of
    ``fn`` enqueued back to back behind a sleeping kernel: the host enqueues
    the calls and both events while the card sleeps, so the events read the
    card's time for the n calls (device time, the gaps between launches
    included), where ``cuda_ms`` (one call between two events) also counts
    the host's wrapper work. Without the sleep, a call whose host work
    outlasts its device work would read the host's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS) -> float:
    """Least time for the work: bytes over HBM rate vs ops over ``peak``."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / peak)


def bound_by(nbytes: float, flops: float, peak: float = F32_FLOPS) -> str:
    return "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak else "operations"


def tensor_bytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


# operations of the quantize-superpose function: per quantized element
# (qmax > 0) the dither's 10 integer ops (xor with the row key, 3 x (shift,
# xor), 2 multiplies, the shift to 24 bits), its int-to-float conversion
# and 11 f32 ops (scale, divide, floor, subtract, compare, add, max, min,
# dequantizing multiply, weighting multiply, add); per passthrough element
# (qmax == 0) 2 f32 ops (multiply, add)
QS_INT_OPS, QS_CVT_OPS, QS_F32_OPS, QS_PASS_F32_OPS = 10, 1, 11, 2
# the H100's rates relative to its f32 peak (an SM: 128 f32 lanes, an FMA 2
# flops): a single f32 op at half F32_FLOPS, an int32 op (64 lanes) at a
# quarter, a conversion (16 lanes) at a sixteenth; and the issue of any
# op, 4 warp-instructions a clock an SM, at half F32_FLOPS too
F32_OPS_PER_S, INT32_OPS_PER_S, CVT_OPS_PER_S = F32_FLOPS / 2, F32_FLOPS / 4, F32_FLOPS / 16
ISSUE_OPS_PER_S = F32_FLOPS / 2


def qs_bounds(nbytes: float, qmax, M: int) -> dict:
    """The bounds of one quantize-superpose call, from the function's own
    work on these inputs: its bytes over the HBM rate, and its operations
    (rows with qmax > 0 quantized, the others passed through) over the
    rate of each pipe they need and over the issue rate, the slowest of
    those setting ``bound_ops_ms`` (``bound_issue_ms`` the issue alone).
    ``bound_ms`` is the larger of bytes and operations."""
    quantized = float(int((qmax > 0).sum())) * M
    passed = float(qmax.numel()) * M - quantized
    f32 = QS_F32_OPS * quantized + QS_PASS_F32_OPS * passed
    every = f32 + (QS_INT_OPS + QS_CVT_OPS) * quantized
    issue_ms = 1e3 * every / ISSUE_OPS_PER_S
    ops_ms = max(issue_ms, 1e3 * f32 / F32_OPS_PER_S,
                 1e3 * QS_INT_OPS * quantized / INT32_OPS_PER_S,
                 1e3 * QS_CVT_OPS * quantized / CVT_OPS_PER_S)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms, "bound_issue_ms": issue_ms}


def qs_other_layout(x, scale, qmax, w, seed, wide, acc_p, ss_p) -> dict:
    """The quantize-superpose kernel in the layout its wrapper does not
    choose at this M, held to the plain version's ``acc_p`` (bit for bit)
    and ``ss_p`` (within 1e-5) and timed beside the chosen one."""
    import torch

    from repro_torch.kernels import ota_fused as kota

    acc, ss = kota.ota_quantize_superpose(x, scale, qmax, w, seed, wide=wide)
    rel = abs(ss.item() - ss_p.item()) / abs(ss_p.item())
    name = "wide" if wide else "narrow"
    if not torch.equal(acc, acc_p) or rel > 1e-5:
        _fail(f"quantize-superpose in the {name} layout != plain at {tuple(x.shape)}")
    ms = cuda_ms(lambda: kota.ota_quantize_superpose(x, scale, qmax, w, seed, wide=wide), reps=10)
    return {"other_layout": name, "other_layout_ms": ms}


# ---------------------------------------------------------------- phase 1


def ptxas_report(log: str) -> dict:
    """Per entry function of a ``-Xptxas -v`` log: registers, stack frame
    and spill bytes."""
    import re

    funcs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return funcs


def _kernel_label(mangled: str) -> str:
    """``flash_fwd_hopper<128>`` from a mangled flash kernel name."""
    import re

    m = re.search(r"\d+(flash_fwd_\w+?)ILi(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def phase_build():
    """Build every source; print nvcc's seconds and ptxas's report, each
    flash_attention kernel by name. A flash_fwd_hopper instantiation with a
    stack frame or spills fails the run."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s for {len(_build.sources())} sources -> {_build.build_dir()}")
    for name, rec in sorted(_build.BUILD_LOG.items()):
        print(f"  {name}.cu nvcc {rec['seconds']:.2f} s")
        log = str(rec["log"])
        if name == "qmatmul":
            funcs = ptxas_report(log)
            for fn, r in funcs.items():
                print(f"    {fn}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
                      f"frame, spill stores/loads {r.get('spill_stores')}/{r.get('spill_loads')}")
                if "qmm_hopper" in fn and (r.get("stack") != 0 or r.get("spill_stores")
                                           or r.get("spill_loads")):
                    _fail(f"{fn} has a stack frame or spills: {r}")
            if not any("qmm_hopper" in fn for fn in funcs):
                _fail("ptxas reported no qmm_hopper kernel")
            continue
        if name == "flash_attention":
            funcs = ptxas_report(log)
            for fn, r in funcs.items():
                label = _kernel_label(fn)
                print(f"    {label}: {r.get('registers')} registers, {r.get('stack')} bytes "
                      f"stack frame, spill stores/loads {r.get('spill_stores')}/"
                      f"{r.get('spill_loads')}")
                if "flash_fwd_hopper" in fn and (r.get("stack") != 0 or r.get("spill_stores")
                                                 or r.get("spill_loads")):
                    _fail(f"{label} has a stack frame or spills: {r}")
            if not any("flash_fwd_hopper" in fn for fn in funcs):
                _fail("ptxas reported no flash_fwd_hopper instantiation")
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"    {line.strip()}")
    lib = _build.library("ota_quantize_superpose")
    per_sm = lib.ota_quantize_superpose_blocks_per_sm
    print(f"  quantize-superpose blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
          f"narrow_kernel {per_sm(0, 4000)}, wide_kernel {per_sm(1, 20)} at K = 20 and "
          f"{per_sm(1, 4000)} at K = 4,000")
    return secs


# ---------------------------------------------------------------- phase 2


def _ds2_layout_size(dev) -> int:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import packing
    from repro_torch.models.registry import build_model

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = build_model(get_arch("deepspeech2")).init(gen, dev)
    return packing.make_layout(params).padded_size


def _make_group(kind, K, M, qblock, gen, dev):
    """Random symbols of one storage class + scales, as the wire builds them."""
    import torch

    lim = {"int4": 7, "int8": 127, "int16": 32767, "int32": 2**30}
    if kind == "int4":
        q = torch.randint(0, 256, (K, M // 2), generator=gen, device=dev, dtype=torch.int64)
        q = q.to(torch.uint8)
    elif kind == "float32":
        q = torch.randn((K, M), generator=gen, device=dev) * 1e-3
    else:
        dt = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32}[kind]
        q = torch.randint(-lim[kind], lim[kind] + 1, (K, M), generator=gen, device=dev,
                          dtype=torch.int64).to(dt)
    nb = -(-M // qblock) if qblock else 1
    scale = torch.rand((K, nb), generator=gen, device=dev) * 1e-3 + 1e-6
    if kind == "float32" and not qblock:
        scale = torch.ones((K, 1), device=dev)
    return q, scale


def check_ota(M: int, dev, timing: bool):
    import torch

    from repro_torch.kernels import ota_fused as kota

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows = []
    errs = {"ota_superpose": 0.0, "ota_fold": 0.0}
    for kind in ("int4", "int8", "int16", "int32", "float32"):
        for qblock in (0, 256):
            for K in (1, 7, 20):
                q, scale = _make_group(kind, K, M, qblock, gen, dev)
                w = torch.rand((K,), generator=gen, device=dev)
                w = w / w.sum()
                acc = torch.randn((M,), generator=gen, device=dev)
                for gains in (None, torch.rand((K,), generator=gen, device=dev)):
                    kw = dict(gains=gains, qblock=qblock, packed4=kind == "int4")
                    sup = kota.ota_superpose(q, scale, w, **kw)
                    sup_p = kota.superpose_plain(q, scale, w, **kw)
                    fold = kota.ota_fold(acc, q, scale, w, **kw)
                    fold_p = kota.superpose_plain(q, scale, w, acc=acc, **kw)
                    fold0 = kota.ota_fold(torch.zeros_like(acc), q, scale, w, **kw)
                    torch.cuda.synchronize()
                    e_sup = (sup - sup_p).abs().max().item()
                    e_fold = (fold - fold_p).abs().max().item()
                    errs["ota_superpose"] = max(errs["ota_superpose"], e_sup)
                    errs["ota_fold"] = max(errs["ota_fold"], e_fold)
                    if not (torch.isfinite(sup).all() and torch.isfinite(fold).all()):
                        _fail(f"non-finite OTA output {kind} qblock={qblock} K={K}")
                    if e_sup != 0.0 or e_fold != 0.0:
                        _fail(f"OTA kernel != plain: {kind} qblock={qblock} K={K} "
                              f"gains={gains is not None} sup={e_sup} fold={e_fold}")
                    if not torch.equal(fold0, sup):
                        _fail(f"fold(zeros, b) != superpose(b): {kind} qblock={qblock} K={K}")
                if timing and K == 20:
                    kw = dict(qblock=qblock, packed4=kind == "int4")
                    sb = tensor_bytes(q, scale, w) + 4 * M
                    rec = {
                        "kind": kind, "qblock": qblock, "K": K,
                        "superpose_ms": cuda_ms(lambda: kota.ota_superpose(q, scale, w, **kw)),
                        "superpose_plain_ms": cuda_ms(
                            lambda: kota.superpose_plain(q, scale, w, **kw)),
                        "superpose_bound_ms": bound_ms(sb, 3.0 * K * M),
                        "fold_ms": cuda_ms(lambda: kota.ota_fold(acc, q, scale, w, **kw)),
                        "fold_plain_ms": cuda_ms(
                            lambda: kota.superpose_plain(q, scale, w, acc=acc, **kw)),
                        "fold_bound_ms": bound_ms(sb + 4 * M, 3.0 * K * M + M),
                        "superpose_library_ms": None,
                        "fold_library_ms": None,
                    }
                    if kind == "float32" and not qblock:
                        # one library call computes the f32 per-row (unit
                        # scale) superpose / fold: a matrix-vector product
                        qt = q.t()
                        rec["superpose_library_ms"] = cuda_ms(lambda: torch.mv(qt, w))
                        rec["fold_library_ms"] = cuda_ms(lambda: torch.addmv(acc, qt, w))
                        lib = torch.mv(qt, w)
                        ref = kota.ota_superpose(q, scale, w, **kw)
                        rec["library_rel_diff"] = (
                            (lib - ref).abs().max() / ref.abs().max()).item()
                    rows.append(rec)
                del q, scale, acc
    print(f"ota superpose/fold: 120 kernel calls vs plain at M={M}, "
          f"max_abs_err {errs} (tolerance: exact), fold(zeros,b)==superpose(b) exact")
    for r in rows:
        print("  ota " + json.dumps(r))
    return errs


def _topk_slab(storage, Np, n, D, gen, dev):
    """A unit-vector slab with duplicated records (exact score ties)."""
    import numpy as np
    import torch

    from repro_torch.retrieval.arena import ArenaStore

    vec = torch.randn((n, D), generator=gen, device=dev)
    vec = vec / vec.norm(dim=1, keepdim=True)
    vec[300:340] = vec[10:50]  # duplicates across chunks
    vec[60:70] = vec[10:20]  # and within one
    store = ArenaStore(D, storage=storage, capacity=Np)
    store.add_batch(vec.cpu().numpy())
    data, scales = store.raw()
    assert data.shape[0] == Np, (data.shape, Np)
    qv = torch.randn((20, D), generator=gen, device=dev)
    qv = qv / qv.norm(dim=1, keepdim=True)
    qv[:5] = vec[10:15]  # queries equal to duplicated records
    return (qv.contiguous(), torch.from_numpy(np.ascontiguousarray(data)).to(dev),
            None if scales is None else torch.from_numpy(scales).to(dev))


def check_topk(dev, timing: bool):
    import torch

    from repro_torch.kernels import topk_similarity as ktk

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    rows = []
    worst = 0.0
    for storage in ("f32", "int8"):
        for Np in (1024, 4096):
            n = Np - 100
            qm, recs, scales = _topk_slab(storage, Np, n, 256, gen, dev)
            s, i = ktk.topk_cosine(qm, recs, scales, n, k=32)
            sp, ip = ktk.topk_plain(qm, recs, scales, n, 32)
            torch.cuda.synchronize()
            if not torch.equal(i, ip):
                _fail(f"top-k indices differ ({storage}, Np={Np})")
            err = (s - sp).abs().max().item()
            worst = max(worst, err)
            if err != 0.0:
                _fail(f"top-k scores differ by {err} ({storage}, Np={Np})")
            # the duplicate queries' best hits are exact ties, lowest index first
            if not (s[0, 0] == s[0, 1] and i[0, 0] < i[0, 1]):
                _fail(f"tie contract not exercised/held ({storage}, Np={Np})")
            if timing:
                nb = tensor_bytes(qm) + n * recs.shape[1] * recs.element_size() + (
                    0 if scales is None else n * scales.shape[1] * 4) + 20 * 32 * 8
                rows.append({
                    "storage": storage, "Np": Np, "n": n, "Q": 20, "k": 32,
                    "ms": cuda_ms(lambda: ktk.topk_cosine(qm, recs, scales, n, k=32)),
                    "plain_ms": cuda_ms(lambda: ktk.topk_plain(qm, recs, scales, n, 32)),
                    "bound_ms": bound_ms(nb, 2.0 * 20 * n * 256),
                    "library_ms": None,
                })
    print("topk: f32/int8 slabs, Np in {1024, 4096}, n = Np - 100, k = 32: indices equal, "
          "max_abs_err 0 (tolerance: exact)")
    for r in rows:
        print("  topk " + json.dumps(r))
    return {"topk_cosine": worst}


def check_qs(M: int, dev):
    """The quantize-superpose kernel against its plain version: every width
    2-31 and 32 (passthrough), K in {1, 7, 20}, the layout's M and a ragged
    M + 3 (scalar edge path); the sum of squares must repeat bit for bit."""
    import torch

    from repro_torch.core import ota
    from repro_torch.kernels import ota_fused as kota

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    widths = list(range(2, 33))
    worst_acc, worst_ss, calls = 0.0, 0.0, 0
    for K in (1, 7, 20):
        for m in (M, M + 3):
            for start in range(0, len(widths), K):
                bits = [widths[(start + i) % len(widths)] for i in range(K)]
                x = torch.randn((K, m), generator=gen, device=dev) * 0.01
                scale, qmax = ota._client_grid(bits, x.abs().amax(dim=1))
                w = torch.rand((K,), generator=gen, device=dev)
                seed = int(torch.randint(0, 2**32, (1,), generator=gen, device=dev))
                acc, ss = kota.ota_quantize_superpose(x, scale, qmax, w, seed)
                acc2, ss2 = kota.ota_quantize_superpose(x, scale, qmax, w, seed)
                acc_p, ss_p = kota.quantize_superpose_plain(x, scale, qmax, w, seed)
                torch.cuda.synchronize()
                calls += 2
                e = (acc - acc_p).abs().max().item()
                rel = abs(ss.item() - ss_p.item()) / max(abs(ss_p.item()), 1e-30)
                worst_acc, worst_ss = max(worst_acc, e), max(worst_ss, rel)
                if e != 0.0 or not torch.isfinite(acc).all():
                    _fail(f"quantize-superpose != plain: K={K} M={m} bits={bits} err={e}")
                if rel > 1e-5:
                    _fail(f"quantize-superpose sumsq rel err {rel} > 1e-5: K={K} M={m}")
                if not (torch.equal(acc, acc2) and torch.equal(ss, ss2)):
                    _fail(f"quantize-superpose differs between launches: K={K} M={m}")
    print(f"ota_quantize_superpose: {calls} kernel calls vs plain, widths 2-32, K in {{1, 7, 20}}, "
          f"M in {{{M}, {M + 3}}}: acc max_abs_err {worst_acc} (tolerance: exact), sumsq max "
          f"rel err {worst_ss:.3e} (tolerance 1e-5), repeat launches identical")
    return {"ota_quantize_superpose": worst_acc}


def flash_work(B: int, Sq: int, Sk: int, H: int, KV: int, D: int, causal: bool, elem: int):
    """(bytes, flops) of one attention call: q and o read/written once at H
    heads, k and v read once at their KV heads; 4 D flops (QK^T and PV) per
    (query, key) pair the mask keeps: Sq Sk pairs a head without the mask,
    sum_i min(i + 1, Sk) with the top-left causal mask."""
    nbytes = elem * (2.0 * B * Sq * H * D + 2.0 * B * Sk * KV * D)
    if causal:
        n = min(Sq, Sk)
        pairs = n * (n + 1) / 2.0 + max(Sq - Sk, 0) * float(Sk)
    else:
        pairs = float(Sq) * Sk
    return nbytes, 4.0 * D * pairs * B * H


# (label, B, Sq, Sk, H, KV, D, causal, dtype): the serve phase's shapes
# (Qwen3-8B), a ragged length, StableLM-1.6B's MHA widths and small f32
# cases; then the widths and masks of the repository's other configs,
# through ``ops.flash_mha`` in the ops phase too (OPS_FLASH_CASES); then
# the families phase's prefills (FAMILY_FLASH_CASES)
FLASH_CASES = (
    ("qwen3-8b", 4, 2048, 2048, 32, 8, 128, True, "bfloat16"),
    ("qwen3-8b ragged", 4, 2000, 2000, 32, 8, 128, True, "bfloat16"),
    ("stablelm-1.6b", 2, 1024, 1024, 32, 32, 64, True, "bfloat16"),
    ("f32 gqa", 2, 300, 300, 4, 2, 64, True, "float32"),
    ("f32 d128", 1, 200, 200, 4, 1, 128, True, "float32"),
    ("zamba2-2.7b", 2, 2048, 2048, 32, 32, 80, True, "bfloat16"),
    ("kimi-k2-1t-a32b", 1, 4096, 4096, 64, 8, 112, True, "bfloat16"),
    ("qwen3-8b non-causal", 4, 2048, 2048, 32, 8, 128, False, "bfloat16"),
    # whisper-tiny's 1,500 encoder frames, cut to the tile-aligned 1,536
    # keys the reference's non-causal precondition needs
    ("whisper-tiny Sk=1536 (1500 frames tile-aligned)", 4, 512, 1536, 6, 6, 64, False,
     "bfloat16"),
    ("Sq > Sk", 2, 4096, 2048, 32, 8, 128, True, "bfloat16"),
    ("f32 d32", 1, 256, 256, 4, 2, 32, True, "float32"),
    ("d40 zero-padded to 64", 1, 256, 384, 4, 2, 40, False, "bfloat16"),
)
OPS_FLASH_CASES = FLASH_CASES[5:]
FAMILY_FLASH_CASES = (
    ("kimi-k2-1t-a32b prefill", 4, 2048, 2048, 64, 8, 112, True, "bfloat16"),
    ("arctic-480b prefill", 4, 2048, 2048, 56, 8, 128, True, "bfloat16"),
    ("qwen2-vl-2b prefill", 4, 2048, 2048, 12, 2, 128, True, "bfloat16"),
    ("zamba2-2.7b prefill", 4, 2048, 2048, 32, 32, 80, True, "bfloat16"),
    ("whisper-tiny decoder prefill", 4, 2048, 2048, 6, 6, 64, True, "bfloat16"),
)
FLASH_CASES += FAMILY_FLASH_CASES


def _flash_inputs(case, gen, dev):
    import torch

    label, B, Sq, Sk, H, KV, D, causal, dt = case
    dtype = getattr(torch, dt)
    return (torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype),
            torch.randn((B, Sk, KV, D), generator=gen, device=dev).to(dtype),
            torch.randn((B, Sk, KV, D), generator=gen, device=dev).to(dtype))


def _flash_tol(dtype) -> str:
    from repro_torch.kernels import flash_attention as kfa

    return (f"(tolerance per element {kfa.TOL_ULPS:g} ulps of |plain| + "
            f"{kfa.TOL_ATOL[dtype]!r}, share differing <= {kfa.TOL_SHARE[dtype]!r})")


def check_flash(dev, timing: bool):
    """The flash kernel against its plain version at every FLASH_CASES
    shape, each timed beside its bound and SDPA (``library_ms``, timing
    only); the plain version is timed at the serve shape (first case)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa

    from repro_torch.kernels import _build

    lib = _build.library("flash_attention") if dev.type == "cuda" else None
    for D in kfa.HEAD_DIMS if lib is not None else ():  # the C route table vs kernel_design
        for dtype, code in kfa._DTYPE_CODE.items():
            got = kfa.DESIGNS[lib.flash_attention_design(D, code)]
            if got != kfa.kernel_design(dtype, D):
                _fail(f"the C launcher runs {got} at {dtype}, D {D}; kernel_design says "
                      f"{kfa.kernel_design(dtype, D)}")
    if lib is not None and lib.flash_attention_design(40, 1) != -1:
        _fail("the C launcher takes D = 40 (the wrapper must pad it)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(777)
    worst, rec = 0.0, None
    for case in FLASH_CASES:
        label, B, Sq, Sk, H, KV, D, causal, dt = case
        dtype = getattr(torch, dt)
        q, k, v = _flash_inputs(case, gen, dev)
        before = kfa.flash_mha.launches
        out = kfa.flash_mha(q, k, v, causal=causal)
        plain = kfa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if kfa.flash_mha.launches != before + 1:
            _fail(f"flash_mha counted {kfa.flash_mha.launches - before} launches for one call")
        if out.shape != q.shape or out.dtype != dtype or not torch.isfinite(out).all():
            _fail(f"flash output {tuple(out.shape)} {out.dtype} not finite or misshapen ({label})")
        mm = kfa.mismatch(out, plain)
        worst = max(worst, mm["max_abs_err"])
        design = kfa.kernel_design(dtype, D)
        print(f"flash {label}: B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} causal={causal} {dt} "
              f"design={design}: {json.dumps(mm)} {_flash_tol(dtype)}")
        if not mm["within"]:
            _fail(f"flash kernel != plain beyond tolerance ({label}): {mm}")
        if timing:
            nbytes, flops = flash_work(B, Sq, Sk, H, KV, D, causal, q.element_size())
            peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=True)

            r = {
                "case": label, "design": design,
                "ms": cuda_ms(lambda: kfa.flash_mha(q, k, v, causal=causal)),
                "bound_ms": bound_ms(nbytes, flops, peak),
                "bound_by": bound_by(nbytes, flops, peak),
                "bound_bytes": nbytes, "bound_flops": flops,
            }
            r["ms_queued"] = cuda_ms_queued(lambda: kfa.flash_mha(q, k, v, causal=causal))
            r["library_ms"], why = _time_library(sdpa)
            if why is None:
                r["library_ms_queued"] = cuda_ms_queued(sdpa)
                r["library_max_abs_diff"] = float(
                    (sdpa().transpose(1, 2).float() - plain.float()).abs().max())
            else:
                r["library_note"] = why
            if rec is None:  # the plain version at one layer's shapes only
                r["plain_ms"] = cuda_ms(lambda: kfa.flash_attention_plain(q, k, v), reps=5)
                rec = r
            print("  flash timing " + json.dumps(r))
        del q, k, v, out, plain
    z = torch.zeros((1, 64, 2, 128), device=dev)
    for what, bad in (
        ("a non-contiguous input", lambda: kfa.flash_mha(*(z.transpose(1, 2),) * 3)),
        ("a float16 input", lambda: kfa.flash_mha(*(z.half(),) * 3)),
        ("D = 192", lambda: kfa.flash_mha(*(torch.zeros((1, 64, 2, 192), device=dev),) * 3)),
        ("non-causal Sk = 64", lambda: kfa.flash_mha(z, z, z, causal=False)),
    ):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        _fail(f"flash_mha accepted {what}")
    return {"flash_attention": worst}, rec


# ---------------------------------------------------------------- phase 3


# the barrier rounds' config: FedAvgM with the velocity kept in bf16 (the
# state phase checkpoints it)
ROUNDS_CFG = dict(n_clients=20, clients_per_round=20, seed=0, server_momentum=0.9,
                  quantize_server_state=True)


def phase_rounds(dev):
    import torch

    from repro_torch import obs
    from repro_torch.configs import FLConfig, QUANT_BLOCK
    from repro_torch.core import ota, packing
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.server import FLServer
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk

    cfg = FLConfig(**ROUNDS_CFG)
    srv = FLServer(cfg, device=dev)
    M = srv.layout.padded_size
    print(f"rounds: DeepSpeech2 {srv.layout.size} params, M={M}, K={cfg.clients_per_round}, "
          f"local_steps={cfg.local_steps}, local_batch={cfg.local_batch}, server_momentum "
          f"{cfg.server_momentum} (bf16 velocity)")
    round_inputs = []
    kota.ota_superpose.launches = 0
    kota.ota_fold.launches = 0
    ktk.topk_cosine.launches = 0
    for rnd in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # host-clock spans of the round stages; both rounds' stay recorded
        # for the state phase's telemetry export
        with obs.enabled(fresh=rnd == 0) as tracer:
            n0 = len(tracer.events)
            log = srv.run_round(rnd)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hist = {}
        for b in log.bits.values():
            hist[b] = hist.get(b, 0) + 1
        print(f"  round {rnd}: bits {dict(sorted(hist.items()))} "
              f"uplink {log.uplink_bytes} B downlink {log.downlink_bytes} B "
              f"participating {log.n_participating} loss {log.train_loss:.4f} "
              f"seconds {secs:.2f}")
        spans = {}
        for e in tracer.events[n0:]:
            spans[e.name] = spans.get(e.name, 0.0) + e.dur_us / 1e3
        spans = {k: round(v, 3) for k, v in spans.items()}
        print(f"    stage ms (host clock, spans): {json.dumps(spans)}")
        rows = srv.last_round["rows"]
        info = srv.last_round["info"]
        want_up = sum(packing.row_wire_bytes(r.bits, M, QUANT_BLOCK) for r in rows)
        if log.uplink_bytes != want_up:
            _fail(f"uplink bytes {log.uplink_bytes} != wire format {want_up}")
        if log.downlink_bytes != 4 * M:
            _fail(f"downlink bytes {log.downlink_bytes} != f32 broadcast {4 * M}")
        if not torch.isfinite(torch.tensor(log.train_loss)):
            _fail("non-finite train loss")
        w = ota.final_weights(info.participation, srv.last_round["weights"], dev)
        plain = ota.aggregate_plain(rows, w)
        got = ota.ota_aggregate_packed.last_acc
        err = (plain - got).abs().max().item()
        print(f"    re-aggregated {len(rows)} packed rows with the plain versions: "
              f"max_abs_err {err} (tolerance: exact)")
        if err != 0.0:
            _fail("round aggregate differs from its plain re-aggregation")
        # the round's own rows, final and cohort weights, draws, and the
        # packed params after it (the mesh phase re-aggregates and compares)
        round_inputs.append(dict(rows=rows, w=w, weights=srv.last_round["weights"],
                                 draws=srv.last_round["draws"]))
    counts = {
        "ota_superpose": kota.ota_superpose.launches,
        "ota_fold": kota.ota_fold.launches,
        "topk_cosine": ktk.topk_cosine.launches,
    }
    print(f"  launches during the rounds: {counts}")
    for name, c in counts.items():
        if c <= 0:
            _fail(f"{name} did not launch on the main path")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(srv.params)):
        _fail("non-finite params after the rounds")
    return srv, counts, round_inputs


def time_round_kernels(srv, round_inputs, dev):
    """Each kernel's time per round on the last round's own inputs: one call
    (``ms``, the host's wrapper work included) and queued back to back
    (``ms_queued``, device time); the top-k held bit for bit against its
    plain version there; and the engine's ``retrieval.query`` split into its
    parts (``retrieval_query_split``)."""
    import torch

    from repro_torch.core.ota import _group_rows
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk

    rows, w = round_inputs[-1]["rows"], round_inputs[-1]["w"]
    kinds, datas, scales, perm = _group_rows(rows)
    wg = w[torch.as_tensor(perm, device=dev)]
    M = srv.layout.padded_size
    calls, off = [], 0
    for (kind, qblock), data, scale in zip(kinds, datas, scales):
        kg = scale.shape[0]
        calls.append((data, scale, wg[off:off + kg].contiguous(), qblock, kind == "int4"))
        off += kg
    acc = torch.zeros(M, device=dev)
    first, rest = calls[0], calls[1:]

    def sup():
        d, s, ww, qb, p4 = first
        return kota.ota_superpose(d, s, ww, qblock=qb, packed4=p4)

    def sup_plain():
        d, s, ww, qb, p4 = first
        return kota.superpose_plain(d, s, ww, qblock=qb, packed4=p4)

    def folds():
        for d, s, ww, qb, p4 in rest:
            kota.ota_fold(acc, d, s, ww, qblock=qb, packed4=p4)

    def folds_plain():
        for d, s, ww, qb, p4 in rest:
            kota.superpose_plain(d, s, ww, qblock=qb, packed4=p4, acc=acc)

    b_sup = tensor_bytes(*first[:3]) + 4 * M
    f_sup = 3.0 * first[0].shape[0] * M
    b_fold = sum(tensor_bytes(*c[:3]) + 8 * M for c in rest)
    f_fold = sum(3.0 * c[0].shape[0] * M + M for c in rest)
    out = {
        "ota_superpose": dict(ms=cuda_ms(sup), ms_queued=cuda_ms_queued(sup),
                              plain_ms=cuda_ms(sup_plain),
                              bound_ms=bound_ms(b_sup, f_sup),
                              bound_by=bound_by(b_sup, f_sup), library_ms=None,
                              shape=f"{kinds[0]} K_g={first[0].shape[0]}"),
        "ota_fold": dict(ms=cuda_ms(folds) if rest else 0.0,
                         ms_queued=cuda_ms_queued(folds) if rest else 0.0,
                         plain_ms=cuda_ms(folds_plain) if rest else 0.0,
                         bound_ms=bound_ms(b_fold, f_fold),
                         bound_by=bound_by(b_fold, f_fold), library_ms=None,
                         shape=" + ".join(f"{k} K_g={c[0].shape[0]}"
                                          for k, c in zip(kinds[1:], rest))),
    }
    # the planner's cohort query on the real RAG store after two rounds
    eng = srv.planner.cqf_db.engine
    data, sc = eng._slab()
    n = len(eng.store)
    from repro_torch.core.profiling.ragdb import embed_batch

    profiles = [srv.planner.profiles[u.user_id].features()
                for u in srv.users[:srv.cfg.clients_per_round]]
    q_np = embed_batch(profiles)
    qv = torch.from_numpy(q_np).to(dev)
    k = min(32, n)
    s, i = ktk.topk_cosine(qv, data, sc, n, k=k)
    sp, ip = ktk.topk_plain(qv, data, sc, n, k)
    if not (torch.equal(i, ip) and torch.equal(s.view(torch.int32), sp.view(torch.int32))):
        _fail(f"top-k != plain on the planner's slab (Q={qv.shape[0]} n={n} k={k})")
    nbytes = tensor_bytes(qv) + n * data.shape[1] * data.element_size() + 20 * k * 8
    flops = 2.0 * qv.shape[0] * n * data.shape[1]
    out["topk_cosine"] = dict(
        ms=cuda_ms(lambda: ktk.topk_cosine(qv, data, sc, n, k=k)),
        ms_queued=cuda_ms_queued(lambda: ktk.topk_cosine(qv, data, sc, n, k=k)),
        plain_ms=cuda_ms(lambda: ktk.topk_plain(qv, data, sc, n, k)),
        bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops),
        library_ms=None, shape=f"Q={qv.shape[0]} Np={data.shape[0]} n={n} k={k}",
    )
    for name, rec in out.items():
        print(f"  per-round timing {name}: " + json.dumps(rec))
    print("  retrieval.query split (host clock, synchronised, median of 20; ms): "
          + json.dumps(retrieval_query_split(eng, q_np, k, dev)))
    return out


def retrieval_query_split(eng, q_np, k, dev) -> dict:
    """The engine's ``topk`` (the ``retrieval.query`` span) on the planner's
    store, whole (``cold``: the slab uploaded again, as after each round's
    appends; ``warm``: the slab cached) and by part: the slab's upload, the
    queries' upload, the kernel call, and the copy of both results back
    (each ``.cpu()`` synchronises). A reading only: ``cold`` drops the
    engine's slab cache, which its next query refills."""
    import numpy as np
    import torch

    from repro_torch.kernels import topk_similarity as ktk

    data_np, scales_np = eng.store.raw()
    n = len(eng.store)

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def cold():
        eng._dev_cache = None
        eng.topk(q_np, k)

    data, sc = eng._slab()
    qv = torch.from_numpy(q_np).to(dev)
    s, i = ktk.topk_cosine(qv, data, sc, n, k=k)
    return {
        "cold_ms": host_ms(cold),
        "warm_ms": host_ms(lambda: eng.topk(q_np, k)),
        "slab_upload_ms": host_ms(lambda: (torch.from_numpy(data_np).to(dev),
                                           None if scales_np is None
                                           else torch.from_numpy(scales_np).to(dev))),
        "query_upload_ms": host_ms(lambda: torch.from_numpy(np.ascontiguousarray(q_np)).to(dev)),
        "kernel_ms": host_ms(lambda: ktk.topk_cosine(qv, data, sc, n, k=k)),
        "copy_back_ms": host_ms(lambda: (s.cpu().numpy(), i.cpu().numpy())),
        "slab_bytes": int(data_np.nbytes + (0 if scales_np is None else scales_np.nbytes)),
    }


# ---------------------------------------------------------------- phase 3b

# the legacy oracle's tolerance against the flat path, the reference's own
# for the same comparison (tests/test_ota.py)
PERTREE_RTOL, PERTREE_ATOL = 1e-4, 1e-5
STATE_BITS = (4, 8, 16, 32)
ROUND_STAGES = ("round", "plan", "retrieval.query", "client_train", "uplink_encode", "fold",
                "finalize", "optimizer", "broadcast_encode", "feedback")


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (NaN payloads and -0.0 included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def uplink_error_bound(x, scale):
    """One scale per element, plus the f32 rounding of x / scale and of
    q * scale: |q| <= |x| / scale + 1, and each operation errs by at most
    2^-24 of its result, so |dq - x| < scale + 2^-23 (|x| + 2 scale)."""
    return scale + 2.0**-23 * (x.abs() + 2 * scale)


def phase_state(srv, dev):
    """The rounds' server state through checkpoints, the planner's database
    restored on the card, the legacy per-tree oracle against row 4, the
    uplink API at full width, and the telemetry export. Returns the
    launches of the paths it drove and its readings."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import QUANT_BLOCK
    from repro_torch.core import ota, packing
    from repro_torch.core.profiling.ragdb import RETRIEVE_K, ContextQuantFeedbackDB, embed_batch
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk

    rec = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_state_")
    try:
        # 1. server state through CheckpointManager
        velocity = getattr(srv, "_velocity", None)
        if velocity is None:
            _fail("the rounds' server has no FedAvgM velocity to save")
        state = {"params": srv.params, "velocity": velocity}
        leaves = tree_flatten(state)[0]
        raw = sum(t.numel() * t.element_size() for t in leaves)
        mgr = CheckpointManager(os.path.join(tmp, "server"), keep=2)
        save_ms = []
        for step in (1, 2, 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(step, state, meta={"round": len(srv.round_logs)})
            save_ms.append(1e3 * (time.perf_counter() - t0))
        if sorted(mgr._steps()) != [2, 3] or os.path.exists(mgr.path(1)):
            _fail(f"CheckpointManager(keep=2) left steps {sorted(mgr._steps())}, want [2, 3]")
        t0 = time.perf_counter()
        got, meta = mgr.restore_latest()
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        if meta != {"round": len(srv.round_logs), "step": 3}:
            _fail(f"restored meta {meta}")
        got_leaves = tree_flatten(got)[0]
        if len(got_leaves) != len(leaves) or tree_flatten(got)[1] != tree_flatten(state)[1]:
            _fail("the restored server state has another structure")
        for a, b in zip(leaves, got_leaves):
            if b.device.type != "cuda" or not _same_bits(a, b):
                _fail(f"a restored leaf {tuple(b.shape)} {b.dtype} on {b.device} differs "
                      "from the saved one")
        with open(mgr.path(3), "rb") as f:
            flag = f.read(1)
        nbytes = os.path.getsize(mgr.path(3))
        rec.update(codec=flag.decode(), file_bytes=nbytes, raw_bytes=raw,
                   ratio=raw / nbytes, save_ms=save_ms, load_ms=load_ms,
                   velocity_dtype=str(velocity.dtype).replace("torch.", ""))
        print(f"state: server params + FedAvgM velocity ({len(leaves)} leaves, {raw} B raw) "
              f"through CheckpointManager(keep=2): codec {flag!r}, file {nbytes} B "
              f"(ratio {raw / nbytes:.4f}), save ms {[round(t, 3) for t in save_ms]}, load ms "
              f"{load_ms:.3f}; step 1 gone, restored leaves on the card bit for bit")

        # 2. the planner's feedback database, restored into a fresh one
        db = srv.planner.cqf_db
        profiles = [srv.planner.profiles[u.user_id].features()
                    for u in srv.users[: srv.cfg.clients_per_round]]
        q_np = embed_batch(profiles)
        s0, i0 = db.engine.topk(q_np, RETRIEVE_K)
        hits0 = db.query_batch(q_np, k=RETRIEVE_K)
        db_path = os.path.join(tmp, "cqf_db.ckpt")
        db.save(db_path)
        fresh = ContextQuantFeedbackDB(device=dev)
        fresh.restore(db_path)
        ktk.topk_cosine.launches = 0
        s1, i1 = fresh.engine.topk(q_np, RETRIEVE_K)
        hits1 = fresh.query_batch(q_np, k=RETRIEVE_K)
        torch.cuda.synchronize()
        topk_launches = ktk.topk_cosine.launches
        if topk_launches <= 0:
            _fail("the restored database's queries did not launch topk_cosine")
        if not (np.array_equal(i0, i1) and np.array_equal(s0.view(np.int32), s1.view(np.int32))):
            _fail("the restored database's top-k differs from the saved one's")
        if [[(s, r.features, r.payload) for s, r in h] for h in hits0] != \
                [[(s, r.features, r.payload) for s, r in h] for h in hits1]:
            _fail("the restored database's hits differ from the saved one's")
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fresh.engine.topk(q_np, RETRIEVE_K)
            times.append(1e3 * (time.perf_counter() - t0))
        rec.update(db_records=len(fresh), db_file_bytes=os.path.getsize(db_path),
                   restored_query_ms=statistics.median(times))
        print(f"  feedback database: {len(fresh)} records, file {rec['db_file_bytes']} B, "
              f"restored on the card; {q_np.shape[0]} planner queries at k {RETRIEVE_K}: "
              f"indices and scores bit for bit, topk_cosine launches {topk_launches}, query "
              f"ms {rec['restored_query_ms']:.4f} (host clock, median of 20)")

        # 3. the legacy per-tree oracle against the flat path (row 4)
        K = 20
        gen = torch.Generator(device=dev)
        gen.manual_seed(2025)
        trees = [tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev) * 0.01,
                          srv.params) for _ in range(K)]
        bits = [STATE_BITS[i % len(STATE_BITS)] for i in range(K)]
        weights = (torch.rand((K,), generator=gen, device=dev) + 0.5).tolist()
        draws = ota.TorchRoundDraws(4242, dev)
        kota.ota_quantize_superpose.launches = 0
        flat, finfo = ota.ota_aggregate(draws, trees, bits, weights)
        torch.cuda.synchronize()
        qs_launches = kota.ota_quantize_superpose.launches
        if qs_launches != 1:
            _fail(f"ota_quantize_superpose launched {qs_launches} times on the flat path (want 1)")
        tree, tinfo = ota.ota_aggregate_pertree(draws, trees, bits, weights)
        torch.cuda.synchronize()
        if finfo["participation"] != tinfo["participation"]:
            _fail("participation differs between the per-tree oracle and the flat path")
        dstd = abs(finfo["noise_std"] - tinfo["noise_std"])
        if not dstd <= 1e-6:
            _fail(f"noise_std differs by {dstd} (tolerance 1e-6)")
        worst, n_out, n_all = 0.0, 0, 0
        for a, b in zip(tree_flatten(flat)[0], tree_flatten(tree)[0]):
            d = (a - b).abs()
            worst = max(worst, d.max().item())
            n_out += int((d > PERTREE_ATOL + PERTREE_RTOL * b.abs()).sum())
            n_all += b.numel()
        if n_out:
            _fail(f"{n_out} of {n_all} elements of the flat path differ from the per-tree "
                  f"oracle beyond rtol {PERTREE_RTOL} / atol {PERTREE_ATOL} (max {worst})")
        flat_ms = cuda_ms(lambda: ota.ota_aggregate(draws, trees, bits, weights), reps=5)
        pertree_ms = cuda_ms(lambda: ota.ota_aggregate_pertree(draws, trees, bits, weights),
                             reps=3, warmup=1)
        rec.update(pertree_ms=pertree_ms, flat_ms=flat_ms, pertree_max_abs_diff=worst,
                   noise_std_diff=dstd)
        print(f"  per-tree oracle vs flat path: K {K}, bits {bits[:4]} x 5, participating "
              f"{tinfo['n_participating']}, noise_std diff {dstd!r}, max |diff| {worst!r}, "
              f"elements beyond rtol {PERTREE_RTOL} / atol {PERTREE_ATOL}: 0 of {n_all}; "
              f"per-tree ms {pertree_ms:.3f}, flat ms {flat_ms:.3f} (CUDA events, "
              f"ota_aggregate whole)")

        # 4. the uplink API at full width
        layout = packing.make_layout(srv.params)
        row = packing.pack(trees[0], layout)
        M = layout.padded_size
        for b in (4, 8, 16):
            wire_row = ota.quantize_uplink(row, b, draws.sr_seed, 0, block=QUANT_BLOCK)
            dq = ota.dequantize_uplink(wire_row, M)
            scale = wire_row.scale.reshape(-1).repeat_interleave(QUANT_BLOCK)[:M]
            d = (dq - row).abs()
            err = (d / scale).max().item()
            n_out = int((d > uplink_error_bound(row, scale)).sum())
            want_bytes = packing.row_wire_bytes(b, M, QUANT_BLOCK)
            print(f"  uplink {b} bits: {wire_row.kind}, wire {wire_row.wire_nbytes} B "
                  f"(row_wire_bytes {want_bytes}), max |dq - row| / scale {err!r}, elements "
                  f"past one scale (with f32 rounding) {n_out}")
            if wire_row.wire_nbytes != want_bytes:
                _fail(f"{b}-bit uplink row has {wire_row.wire_nbytes} B, the format "
                      f"{want_bytes}")
            if n_out:
                _fail(f"{b}-bit uplink: {n_out} elements err more than one scale")
        dbits = ota.digital_uplink_bits(bits, layout.size)
        if dbits != sum(bits) * layout.size or ota.channel_uses(bits, layout.size) != layout.size:
            _fail("digital_uplink_bits / channel_uses disagree with their definitions")
        print(f"  digital_uplink_bits {dbits} = sum(bits) x {layout.size}; channel_uses "
              f"{layout.size}")

        # 5. telemetry of the rounds
        jsonl, trace = os.path.join(tmp, "telemetry.jsonl"), os.path.join(tmp, "trace.json")
        obs.export.dump_telemetry(jsonl, trace)
        with open(jsonl) as f:
            lines = [json.loads(line) for line in f]
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = {e["name"] for e in events}
        missing = [s for s in ROUND_STAGES if s not in names]
        if missing:
            _fail(f"the rounds' trace lacks the stages {missing}")
        if {ln["name"] for ln in lines if ln["kind"] == "span"} != names:
            _fail("the JSONL span lines and the Perfetto events name other spans")
        rec.update(jsonl_lines=len(lines), trace_events=len(events))
        print(f"  telemetry: {len(lines)} JSONL lines, {len(events)} Perfetto events of "
              f"{len(names)} span names (the round stages all present)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("  state readings " + json.dumps(rec))
    return {"topk_cosine": topk_launches, "ota_quantize_superpose": qs_launches}, rec


# ---------------------------------------------------------------- phase 3c

# the barrier rounds' shard counts: 4 cuts the DeepSpeech2 layout's
# 4,134,912 symbols into chunks of 1,033,728 (no padding), 5 into 827,136
# (768 columns of padding)
MESH_SHARDS = (4, 5)
# the retrieval arena at a deployment's size: 262,144 records of the
# planner's width, 1,000 of them padding; the row-sharded top-k on 4 shards
MESH_ARENA_ROWS = 262_144
MESH_ARENA_LIVE = MESH_ARENA_ROWS - 1_000
MESH_TOPK_SHARDS = 4
MESH_TOPK_Q = 20  # the planner's cohort of queries
MESH_DUP_FAR = 200_000  # a copy of records 10-109 in the last shard


def _bits_equal(a, b) -> bool:
    """Equal shapes and f32 bit patterns (-0.0 differs from +0.0)."""
    import torch

    return tuple(a.shape) == tuple(b.shape) and torch.equal(a.view(torch.int32),
                                                             b.view(torch.int32))


def _counted(counts: dict, fn):
    """``fn()`` with the counters of rows 1-3 zeroed just before it; what it
    launched is added to ``counts`` and returned beside its result."""
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk

    wrappers = {"ota_superpose": kota.ota_superpose, "ota_fold": kota.ota_fold,
                "topk_cosine": ktk.topk_cosine}
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    got = {n: w.launches for n, w in wrappers.items()}
    for n, c in got.items():
        counts[n] += c
    return out, got


def _mesh_barrier(layout, ocfg, round_inputs, meshes, counts, dev):
    """Each barrier round's rows aggregated again through
    ``ota_aggregate_packed(mesh=)`` with the round's own weights and draws,
    bit for bit the unsharded kernel path (itself bit for bit the plain
    versions'), shards x groups launches."""
    import torch

    from repro_torch.core import ota
    from repro_torch.core.tree import tree_leaves

    M = layout.padded_size
    for rnd, inp in enumerate(round_inputs):
        rows, weights, draws = inp["rows"], inp["weights"], inp["draws"]
        kinds, datas, scales, perm = ota._group_rows(rows)
        wg = inp["w"][torch.as_tensor(perm, device=dev)]
        want, winfo = ota.ota_aggregate_packed(draws, rows, None, weights, layout, ocfg)
        acc_ref = ota.ota_aggregate_packed.last_acc
        if not _bits_equal(acc_ref, ota.aggregate_plain(rows, inp["w"])):
            _fail(f"round {rnd}: the unsharded aggregate != the plain versions'")

        def agg(mesh=None):
            return ota.ota_aggregate_packed(draws, rows, None, weights, layout, ocfg, mesh=mesh)

        def fold(mesh=None):
            return ota._fold_groups(None, kinds, datas, scales, wg, mesh=mesh)

        rec = {"round": rnd, "M": M, "groups": [f"{k}/{qb} K_g={d.shape[0]}"
                                               for (k, qb), d in zip(kinds, datas)],
               "aggregate_ms": cuda_ms(agg, reps=10), "fold_ms": cuda_ms(fold, reps=10),
               "fold_ms_queued": cuda_ms_queued(fold)}
        for n in MESH_SHARDS:
            mesh = meshes[n]
            (got, info), launched = _counted(counts, lambda: agg(mesh))
            torch.cuda.synchronize()
            acc = ota.ota_aggregate_packed.last_acc
            want_l = {"ota_superpose": n, "ota_fold": n * (len(kinds) - 1), "topk_cosine": 0}
            if launched != want_l:
                _fail(f"sharded aggregate launches {launched} != shards x groups {want_l}")
            if not _bits_equal(acc, acc_ref):
                _fail(f"round {rnd}: aggregate on {n} shards != the unsharded kernel path")
            if not all(_bits_equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want))):
                _fail(f"round {rnd}: update tree on {n} shards != the unsharded one")
            if info["noise_std"] != winfo["noise_std"]:
                _fail(f"round {rnd}: noise_std on {n} shards != the unsharded one")
            mc = ota._shard_chunk(M, n, kinds)
            rec[f"shards_{n}"] = {
                "chunk": mc, "padded_columns": n * mc - M, "launches": launched,
                "max_abs_err": (acc - acc_ref).abs().max().item(),
                "aggregate_ms": cuda_ms(lambda: agg(mesh), reps=10),
                "fold_ms": cuda_ms(lambda: fold(mesh), reps=10),
                "fold_ms_queued": cuda_ms_queued(lambda: fold(mesh))}
        print("  mesh barrier " + json.dumps(rec))


def _mesh_stream(layout, ocfg, meshes, counts, dev):
    """One fading ``StreamingFLServer`` round on a 4-shard mesh (an on-time
    and a late wave, staleness and gains), and its waves folded again on no
    mesh and on 4 and 5 shards: each bit for bit the waves' refold with the
    plain versions (``ota.aggregate_plain``), shards x groups launches."""
    import torch

    from repro_torch.configs import QUANT_BLOCK, FLConfig
    from repro_torch.core import ota, packing
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import LatencyModel, StreamingFLServer

    n0 = MESH_SHARDS[0]
    M = layout.padded_size
    cfg = FLConfig(n_clients=20, clients_per_round=20, seed=0, local_steps=1,
                   channel_model="fading", mesh_data_shards=n0)
    srv = StreamingFLServer(cfg, device=dev, fill_fraction=0.7, grace_s=STREAM_GRACE_S,
                            latency=LatencyModel.with_tail(5.0), mesh=meshes[n0])
    if srv.mesh is None or srv.mesh.shape != {"data": n0}:
        _fail(f"StreamingFLServer(mesh_data_shards={n0}) has no {n0}-shard mesh")
    t0 = time.perf_counter()
    log, launched = _counted(counts, lambda: srv.run_round(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    last = srv.last_round
    waves = last["waves"]
    if not log.n_late or len(waves) < 2 or any(wv["gains"] is None for wv in waves):
        _fail("the mesh stream round lacks a late wave with gains")
    sup, fold = _expected_launches(waves)
    if (launched["ota_superpose"], launched["ota_fold"]) != (n0 * sup, n0 * fold):
        _fail(f"stream round launches {launched} != shards x the waves' groups "
              f"{(n0 * sup, n0 * fold)}")
    want_up = sum(packing.row_wire_bytes(r.bits, M, QUANT_BLOCK) for r in last["rows"])
    if log.uplink_bytes != want_up or log.downlink_bytes != 4 * M:
        _fail(f"mesh stream bytes {log.uplink_bytes}/{log.downlink_bytes} != wire format")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(srv.params)):
        _fail("non-finite params after the mesh stream round")

    def refold(mesh=None):
        acc = ota.OtaAccumulator(layout, ocfg, mesh=mesh)
        for wv in waves:
            acc.fold(wv["rows"], wv["weights"], staleness=wv["staleness"], gains=wv["gains"])
        return acc.accumulator

    ref = None
    for wv in waves:
        w = wv["weights"]
        if wv["staleness"] is not None:
            w = w * torch.tensor(wv["staleness"], dtype=torch.float32, device=dev)
        ref = ota.aggregate_plain(wv["rows"], w, wv["gains"], acc=ref)
    if not _bits_equal(last["acc"], ref):
        _fail(f"the {n0}-shard stream round's accumulator != the plain versions' refold")
    if not _bits_equal(refold(), ref):
        _fail("the unsharded kernel refold != the plain versions' refold")
    rec = {"waves": [len(wv["rows"]) for wv in waves], "on_time": log.n_on_time,
           "late": log.n_late, "lost": log.n_lost, "round_seconds": secs,
           "round_launches": launched, "refold_ms": cuda_ms(refold, reps=10)}
    for n in MESH_SHARDS:
        mesh = meshes[n]
        got, launched_n = _counted(counts, lambda: refold(mesh))
        torch.cuda.synchronize()
        if (launched_n["ota_superpose"], launched_n["ota_fold"]) != (n * sup, n * fold):
            _fail(f"stream refold launches {launched_n} != {(n * sup, n * fold)}")
        if not _bits_equal(got, ref):
            _fail(f"stream waves folded on {n} shards != the plain versions' refold")
        rec[f"shards_{n}"] = {"launches": launched_n, "refold_ms": cuda_ms(lambda: refold(mesh),
                                                                        reps=10)}
    print("  mesh stream " + json.dumps(rec))
    del srv


def _mesh_knob(layout, meshes, counts, dev):
    """One barrier round through a fresh ``FLServer(mesh_data_shards=4)``
    at full width on a 4-shard mesh of the card: bytes, finite params, its
    aggregate bit for bit an unsharded aggregation of its own rows. The
    knob alone spans four distinct cards and raises with fewer."""
    import torch

    from repro_torch.configs import QUANT_BLOCK, FLConfig
    from repro_torch.core import ota, packing
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import FLServer

    M = layout.padded_size
    n0 = MESH_SHARDS[0]
    cfg = FLConfig(**ROUNDS_CFG, mesh_data_shards=n0)
    if dev.type == "cuda" and torch.cuda.device_count() < n0:
        try:
            FLServer(cfg, device=dev)
        except ValueError as e:
            print(f"  mesh knob alone on {torch.cuda.device_count()} card(s) raises: {e}")
        else:
            _fail(f"FLServer(mesh_data_shards={n0}) built a mesh on fewer than {n0} cards")
    srv = FLServer(cfg, device=dev, mesh=meshes[n0])
    if srv.mesh is None or srv.mesh.shape != {"data": n0}:
        _fail(f"FLServer(mesh=) has no {n0}-shard mesh")
    t0 = time.perf_counter()
    log, launched = _counted(counts, lambda: srv.run_round(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acc = ota.ota_aggregate_packed.last_acc
    last = srv.last_round
    groups = len(ota._group_rows(last["rows"])[0])
    if (launched["ota_superpose"], launched["ota_fold"]) != (n0, n0 * (groups - 1)):
        _fail(f"mesh round launches {launched} != shards x groups")
    want_up = sum(packing.row_wire_bytes(r.bits, M, QUANT_BLOCK) for r in last["rows"])
    if log.uplink_bytes != want_up or log.downlink_bytes != 4 * M:
        _fail(f"mesh round bytes {log.uplink_bytes}/{log.downlink_bytes} != wire format")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(srv.params)):
        _fail("non-finite params after the mesh round")
    ota.ota_aggregate_packed(last["draws"], last["rows"], None, last["weights"], layout,
                             ota.OTAConfig(snr_db=srv.cfg.snr_db))
    if not _bits_equal(acc, ota.ota_aggregate_packed.last_acc):
        _fail("the mesh round's aggregate != the unsharded aggregation of its rows")
    print(f"  mesh knob: FLServer(mesh_data_shards={n0}) round 0 in {secs:.2f} s, launches "
          f"{launched}, bytes {log.uplink_bytes}/{log.downlink_bytes} as the wire format, "
          f"params finite, aggregate == unsharded aggregation of its rows: True")
    del srv


def _mesh_retrieval(meshes, counts, dev):
    """The row-sharded top-k over a 262,144-record arena of the planner's
    width, f32 and int8, with exact duplicate records, k 32 and 128:
    ``ops.topk_cosine_sharded`` and ``RetrievalEngine(mesh=)`` bit for bit
    the unsharded kernel and ``topk_plain`` (indices equal, scores bit for
    bit, as ``check_topk``), one launch a shard; row 3 timed at this size
    beside its bound and its plain version."""
    import numpy as np
    import torch

    from repro_torch.core.profiling.ragdb import EMBED_DIM
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_similarity as ktk
    from repro_torch.retrieval.arena import ArenaStore
    from repro_torch.retrieval.engine import RetrievalEngine

    n, Q, ns = MESH_ARENA_LIVE, MESH_TOPK_Q, MESH_TOPK_SHARDS
    mesh = meshes[ns]
    gen = torch.Generator(device=dev).manual_seed(27)
    vec = torch.randn((n, EMBED_DIM), generator=gen, device=dev)
    vec = vec / vec.norm(dim=1, keepdim=True)
    vec[60:70] = vec[10:20]  # duplicates in shard 0
    vec[MESH_DUP_FAR:MESH_DUP_FAR + 100] = vec[10:110]  # and in the last shard
    qv = torch.randn((Q, EMBED_DIM), generator=gen, device=dev)
    qv = qv / qv.norm(dim=1, keepdim=True)
    qv[:5] = vec[10:15]  # queries equal to triplicated records
    qv = qv.contiguous()
    q_np, vec_np = qv.cpu().numpy(), vec.cpu().numpy()
    del vec
    for storage in ("f32", "int8"):
        t0 = time.perf_counter()
        store = ArenaStore(EMBED_DIM, storage=storage, capacity=MESH_ARENA_ROWS)
        store.add_batch(vec_np)
        build_s = time.perf_counter() - t0
        data, scales = store.raw()
        if data.shape[0] != MESH_ARENA_ROWS:
            _fail(f"arena capacity {data.shape[0]} != {MESH_ARENA_ROWS}")
        recs = torch.from_numpy(data).to(dev)
        sc = None if scales is None else torch.from_numpy(scales).to(dev)
        eng = RetrievalEngine(store, device=dev, mesh=mesh)
        for k in (32, 128):
            s0, i0 = ktk.topk_cosine(qv, recs, sc, n, k=k)
            sp, ip = ktk.topk_plain(qv, recs, sc, n, k)
            (s1, i1), l1 = _counted(counts, lambda: ops.topk_cosine_sharded(
                qv, recs, sc, n, k=k, mesh=mesh, use_kernel=True))
            (s2, i2), l2 = _counted(counts, lambda: eng.topk(q_np, k))
            torch.cuda.synchronize()
            for name, launched in (("topk_cosine_sharded", l1), ("RetrievalEngine", l2)):
                if launched != {"ota_superpose": 0, "ota_fold": 0, "topk_cosine": ns}:
                    _fail(f"{name} launches {launched} != one a shard ({ns})")
            if not (torch.equal(i0, ip) and _bits_equal(s0, sp)):
                _fail(f"the unsharded top-k kernel != topk_plain ({storage}, k={k})")
            if not (torch.equal(i1, ip) and _bits_equal(s1, sp)):
                _fail(f"sharded top-k != topk_plain ({storage}, k={k})")
            if not (np.array_equal(i2, i0.cpu().numpy())
                    and s2.tobytes() == s0.cpu().numpy().tobytes()):
                _fail(f"RetrievalEngine(mesh=) != the unsharded kernel ({storage}, k={k})")
            if not (i0[0, :3].tolist() == [10, 60, MESH_DUP_FAR]
                    and s0[0, 0] == s0[0, 1] == s0[0, 2]):
                _fail(f"tie contract not exercised/held at {MESH_ARENA_ROWS} rows ({storage})")
            if not (bool((i1 < n).all()) and bool(torch.isfinite(s1).all())):
                _fail(f"the sharded merge took a record past the live count ({storage}, k={k})")
            nb = (tensor_bytes(qv) + n * recs.shape[1] * recs.element_size()
                  + (0 if sc is None else n * sc.shape[1] * 4) + Q * k * 8)
            flops = 2.0 * Q * n * recs.shape[1]
            rec = {"storage": storage, "Np": MESH_ARENA_ROWS, "n": n, "Q": Q, "k": k,
                   "shards": ns, "arena_build_s": build_s,
                   "max_abs_err": (s1 - sp).abs().max().item(),
                   "ms": cuda_ms(lambda: ktk.topk_cosine(qv, recs, sc, n, k=k)),
                   "ms_queued": cuda_ms_queued(lambda: ktk.topk_cosine(qv, recs, sc, n, k=k)),
                   "sharded_ms": cuda_ms(lambda: ops.topk_cosine_sharded(
                       qv, recs, sc, n, k=k, mesh=mesh, use_kernel=True)),
                   "sharded_ms_queued": cuda_ms_queued(lambda: ops.topk_cosine_sharded(
                       qv, recs, sc, n, k=k, mesh=mesh, use_kernel=True)),
                   "engine_ms": cuda_ms(lambda: eng.topk(q_np, k), reps=10),
                   "plain_ms": cuda_ms(lambda: ktk.topk_plain(qv, recs, sc, n, k), reps=3),
                   "bound_ms": bound_ms(nb, flops), "bound_by": bound_by(nb, flops),
                   "library_ms": None}
            print("  mesh topk " + json.dumps(rec))
        print(f"  mesh arena {storage}: shard_nbytes({ns}) {store.shard_nbytes(ns)} B a shard, "
              f"shard_rows {store.shard_rows(ns)}, bounds {store.shard_bounds(ns)}, "
              f"shard_nbytes(1) {store.shard_nbytes(1)} B")
        del recs, sc, eng, store


def phase_mesh(srv, round_inputs, dev):
    """The sharded data planes on one card: meshes of n shards all on
    ``dev``, every result bit for bit against the unsharded kernel path.
    Returns the launches of rows 1-3 on the sharded paths (the unsharded
    comparisons not counted)."""
    from repro_torch.core import ota
    from repro_torch.launch.mesh import make_data_mesh

    counts = {"ota_superpose": 0, "ota_fold": 0, "topk_cosine": 0}
    meshes = {n: make_data_mesh(n, devices=[dev] * n) for n in (*MESH_SHARDS, MESH_TOPK_SHARDS)}
    ocfg = ota.OTAConfig(snr_db=srv.cfg.snr_db)
    t0 = time.perf_counter()
    print(f"mesh: meshes of {sorted(meshes)} shards on {dev}; DeepSpeech2 M="
          f"{srv.layout.padded_size}")
    _mesh_barrier(srv.layout, ocfg, round_inputs, meshes, counts, dev)
    _mesh_stream(srv.layout, ocfg, meshes, counts, dev)
    _mesh_knob(srv.layout, meshes, counts, dev)
    _mesh_retrieval(meshes, counts, dev)
    print(f"  launches on the sharded paths: {counts} ({time.perf_counter() - t0:.1f} s)")
    for name, c in counts.items():
        if c <= 0:
            _fail(f"{name} did not launch on the sharded paths")
    return counts


# the barrier round's storage groups as the rounds phase reads them at
# seed 0 (the last round's int4 group, then its int8 and int16 groups),
# the planner's top-k after two rounds (Q, D, Np, n, k) and the ops phase's
ROWS_SUPERPOSE = (("int4", 2),)
ROWS_FOLDS = (("int8", 6), ("int16", 12))
ROWS_TOPK = (("f32", 20, 256, 1024, 40, 32), ("int8", 20, 256, 4096, 3996, 128))


def _sparse_queries_and_slab(storage, Q, D, Np, n, gen, dev):
    """Sparse unit records and queries like the planner's hashed embeddings
    (4 nonzeros of +-1/2 each), through an arena of capacity Np."""
    import torch

    from repro_torch.retrieval.arena import ArenaStore

    def sparse(rows):
        v = torch.zeros((rows, D))
        idx = torch.rand((rows, D), generator=gen).argsort(dim=1)[:, :4]
        sign = torch.randint(0, 2, (rows, 4), generator=gen).float() - 0.5
        return v.scatter_(1, idx, sign)

    store = ArenaStore(D, storage=storage, capacity=Np)
    store.add_batch(sparse(n).numpy())
    data, scales = store.raw()
    return (sparse(Q).to(dev), torch.from_numpy(data).to(dev),
            None if scales is None else torch.from_numpy(scales).to(dev))


def phase_rows(dev):
    """Rows 1-3 at the barrier round's shapes on seeded data (no training):
    the superpose of the round's first storage group, the folds of the
    rest, the planner's top-k and the ops phase's; each held bit for bit
    against its plain version and timed one call (``ms``) and queued
    (``ms_queued``). Seconds of work: the way to read two trees in turns."""
    import torch

    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk

    M = _ds2_layout_size(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    groups = {}
    for kind, K in ROWS_SUPERPOSE + ROWS_FOLDS:
        q, scale = _make_group(kind, K, M, 256, gen, dev)
        w = torch.rand((K,), generator=gen, device=dev) / 20
        groups[kind] = (q, scale, w)
    acc = torch.randn((M,), generator=gen, device=dev)
    recs = {}

    def sup():
        return [kota.ota_superpose(*groups[k], qblock=256, packed4=k == "int4")
                for k, _ in ROWS_SUPERPOSE]

    def folds():
        return [kota.ota_fold(acc, *groups[k], qblock=256, packed4=k == "int4")
                for k, _ in ROWS_FOLDS]

    for (kind, _), got in zip(ROWS_SUPERPOSE, sup()):
        if not torch.equal(got, kota.superpose_plain(*groups[kind], qblock=256,
                                                     packed4=kind == "int4")):
            _fail(f"superpose != plain ({kind})")
    for (kind, _), got in zip(ROWS_FOLDS, folds()):
        if not torch.equal(got, kota.superpose_plain(*groups[kind], qblock=256, acc=acc)):
            _fail(f"fold != plain ({kind})")
    recs["ota_superpose " + " + ".join(f"{k} K_g={K}" for k, K in ROWS_SUPERPOSE)] = dict(
        ms=cuda_ms(sup), ms_queued=cuda_ms_queued(sup))
    recs["ota_fold " + " + ".join(f"{k} K_g={K}" for k, K in ROWS_FOLDS)] = dict(
        ms=cuda_ms(folds), ms_queued=cuda_ms_queued(folds))
    cpu_gen = torch.Generator().manual_seed(21)
    topk_calls = {}
    for storage, Q, D, Np, n, k in ROWS_TOPK:
        qm, data, sc = _sparse_queries_and_slab(storage, Q, D, Np, n, cpu_gen, dev)
        s, i = ktk.topk_cosine(qm, data, sc, n, k=k)
        sp, ip = ktk.topk_plain(qm, data, sc, n, k)
        if not (torch.equal(i, ip) and torch.equal(s.view(torch.int32), sp.view(torch.int32))):
            _fail(f"top-k != plain ({storage} Np={Np} n={n} k={k})")
        name = f"topk_cosine {storage} Q={Q} Np={Np} n={n} k={k}"
        topk_calls[name] = (lambda qm=qm, data=data, sc=sc, n=n, k=k:
                            ktk.topk_cosine(qm, data, sc, n, k=k))
        recs[name] = dict(ms=cuda_ms(topk_calls[name]), ms_queued=cuda_ms_queued(topk_calls[name]))
    for name, rec in recs.items():
        print(f"  rows {name}: " + json.dumps(rec))
    prof = {"ota_superpose": profiled_kernel_us(sup), "ota_fold": profiled_kernel_us(folds)}
    prof.update({name: profiled_kernel_us(fn) for name, fn in topk_calls.items()})
    print("  rows kernel us a call (torch.profiler, 10 calls each): " + json.dumps(prof))
    return recs


def profiled_kernel_us(fn, calls: int = 10) -> dict:
    """Device microseconds a call of each kernel ``fn`` launches, as the
    profiler's CUDA activity records them (the kernel's own duration,
    without the gaps between launches); {} where the trace holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.count:
            out[ev.key[:60]] = dev_us / calls
    return out


# ---------------------------------------------------------------- phase 4


def phase_flat(dev, plan_bits):
    """``ota.ota_aggregate`` on 20 full-width f32 update trees."""
    import torch

    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.core import ota, packing
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.models.registry import build_model

    K = 20
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    shapes = build_model(get_arch("deepspeech2")).init(gen, dev)
    trees = [tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev) * 0.01, shapes)
             for _ in range(K)]
    bits = [int(b) for b in plan_bits][:K]
    if len(bits) != K:
        _fail(f"the barrier round planned {len(bits)} rows, the flat phase needs {K}")
    bits[-1] = 32  # one unquantized (passthrough) row
    weights = (torch.rand((K,), generator=gen, device=dev) + 0.5).tolist()
    draws = ota.TorchRoundDraws(777, dev)

    kota.ota_quantize_superpose.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.enabled() as tracer:
        agg, info = ota.ota_aggregate(draws, trees, bits, weights)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kota.ota_quantize_superpose.launches

    layout = packing.make_layout(trees[0])
    M = layout.padded_size
    hist = {}
    for b in bits:
        hist[b] = hist.get(b, 0) + 1
    spans = {k: round(v["total_us"] / 1e3, 3) for k, v in tracer.summary().items()}
    print(f"flat: K={K} f32 DeepSpeech2 trees, M={M} ({4 * K * M} B of x), bits "
          f"{dict(sorted(hist.items()))}, participating {info['n_participating']}, noise_std "
          f"{info['noise_std']:.6g}, seconds {secs:.3f}, launches {launches}")
    print(f"  stage ms (host clock, spans): {json.dumps(spans)}")
    if launches != 1:
        _fail(f"ota_quantize_superpose launched {launches} times on the flat path (want 1)")
    leaves = tree_leaves(agg)
    if [tuple(t.shape) for t in leaves] != [tuple(t.shape) for t in tree_leaves(trees[0])]:
        _fail("flat aggregate has the wrong tree shapes")
    if not all(bool(torch.isfinite(t).all()) for t in leaves) or not info["noise_std"] > 0:
        _fail("flat aggregate is not finite or its noise_std is not positive")

    X = packing.pack_batch(trees, layout)
    w = ota.final_weights(info.participation, weights, dev)
    scale, qmax = ota._client_grid(bits, X.abs().amax(dim=1))
    seed = draws.sr_seed
    main_acc = ota.ota_aggregate_packed.last_acc
    acc, ss = kota.ota_quantize_superpose(X, scale, qmax, w, seed)
    acc2, ss2 = kota.ota_quantize_superpose(X, scale, qmax, w, seed)
    acc_p, ss_p = kota.quantize_superpose_plain(X, scale, qmax, w, seed)
    torch.cuda.synchronize()
    err = (acc - acc_p).abs().max().item()
    rel = abs(ss.item() - ss_p.item()) / abs(ss_p.item())
    print(f"  kernel vs plain on the path's inputs: acc max_abs_err {err} (tolerance: exact), "
          f"sumsq {ss.item()!r} vs {ss_p.item()!r}, rel err {rel:.3e} (tolerance 1e-5)")
    if not torch.equal(acc, main_acc):
        _fail("the flat path's aggregate differs from a second kernel launch on its inputs")
    if err != 0.0:
        _fail(f"quantize-superpose != plain on the flat path: {err}")
    if rel > 1e-5:
        _fail(f"quantize-superpose sumsq rel err {rel} > 1e-5")
    if not (torch.equal(acc, acc2) and torch.equal(ss, ss2)):
        _fail("quantize-superpose differs between two launches")
    wide = M >= kota._QS_WIDE_M
    other = qs_other_layout(X, scale, qmax, w, seed, not wide, acc_p, ss_p)

    # timing on the path's inputs, and the all-32-bit case beside torch.mv
    nbytes = tensor_bytes(X, scale, qmax, w) + 4 * M
    ones, zeros, xt = torch.ones_like(scale), torch.zeros_like(qmax), X.t()
    rec = {
        "K": K, "M": M, "bits": bits, "layout": "wide" if wide else "narrow", **other,
        "ms": cuda_ms(lambda: kota.ota_quantize_superpose(X, scale, qmax, w, seed)),
        "plain_ms": cuda_ms(lambda: kota.quantize_superpose_plain(X, scale, qmax, w, seed), reps=5),
        "bound_bytes": nbytes,
        **qs_bounds(nbytes, qmax, M),
        "all32_ms": cuda_ms(lambda: kota.ota_quantize_superpose(X, ones, zeros, w, seed)),
        "library_ms": cuda_ms(lambda: torch.mv(xt, w)),
    }
    lib = torch.mv(xt, w)
    k32, _ = kota.ota_quantize_superpose(X, ones, zeros, w, seed)
    rec["library_rel_diff"] = ((lib - k32).abs().max() / k32.abs().max()).item()
    print("  flat timing " + json.dumps(rec))
    return launches, err, rec


# ---------------------------------------------------------------- phase 5


def _expected_launches(waves):
    """(superpose, fold) launches the waves' storage groups imply: the first
    group of a fresh accumulator is a superpose, every other group a fold."""
    from repro_torch.core.ota import _group_rows

    sup = fold = 0
    fresh = True
    for wave in waves:
        if not wave["rows"]:
            continue
        n_groups = len(_group_rows(wave["rows"])[0])
        if fresh:
            sup, fold, fresh = sup + 1, fold + n_groups - 1, False
        else:
            fold += n_groups
    return sup, fold


def phase_stream(dev):
    import torch

    from repro_torch import obs
    from repro_torch.configs import QUANT_BLOCK, FLConfig
    from repro_torch.core import channel, ota, packing
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import LatencyModel, StreamingFLServer
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk

    cfg = FLConfig(n_clients=20, clients_per_round=20, seed=0, local_steps=1,
                   channel_model="fading")
    srv = StreamingFLServer(cfg, device=dev, fill_fraction=0.7, grace_s=STREAM_GRACE_S,
                            latency=LatencyModel.with_tail(5.0))
    M = srv.layout.padded_size
    print(f"stream: DeepSpeech2 M={M}, K={cfg.clients_per_round}, fading (threshold "
          f"{cfg.fade_threshold}, budget {cfg.tx_power_budget}), fill 0.7, grace "
          f"{STREAM_GRACE_S} s, latency p95/p50 5.0, local_steps {cfg.local_steps}")
    names = ("ota_superpose", "ota_fold", "topk_cosine")
    fns = (kota.ota_superpose, kota.ota_fold, ktk.topk_cosine)
    counts = dict.fromkeys(names, 0)
    for rnd in range(2):
        for fn in fns:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.enabled() as tracer:
            log = srv.run_round(rnd)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {n: fn.launches for n, fn in zip(names, fns)}
        for n in names:
            counts[n] += got[n]
        last = srv.last_round
        waves = last["waves"]
        hist = {}
        for b in log.bits.values():
            hist[b] = hist.get(b, 0) + 1
        print(f"  round {rnd}: bits {dict(sorted(hist.items()))} on_time {log.n_on_time} late "
              f"{log.n_late} lost {log.n_lost} truncated {srv.last_channel.n_truncated} uplink "
              f"{log.uplink_bytes} B downlink {log.downlink_bytes} B participating "
              f"{log.n_participating} loss {log.train_loss:.4f} sim_seconds "
              f"{log.sim_seconds:.3f} seconds {secs:.2f} launches {got}")
        spans = {k: round(v["total_us"] / 1e3, 3) for k, v in tracer.summary().items()}
        print(f"    stage ms (host clock, spans): {json.dumps(spans)}")
        if not (log.n_on_time and log.n_late and log.n_lost):
            _fail("a stream round lacks an on-time wave, a late wave or lost rows")
        if last["gains"] is None or any(wv["gains"] is None for wv in waves):
            _fail("a fading round folded without its gains")
        want = _expected_launches(waves)
        if (got["ota_superpose"], got["ota_fold"]) != want:
            _fail(f"superpose/fold launches {got} != the waves' groups {want}")
        rows = last["rows"]
        want_up = sum(packing.row_wire_bytes(r.bits, M, QUANT_BLOCK) for r in rows)
        if log.uplink_bytes != want_up or log.downlink_bytes != 4 * M:
            _fail(f"stream bytes {log.uplink_bytes}/{log.downlink_bytes} != wire format "
                  f"{want_up}/{4 * M}")
        # the waves re-folded with the plain versions
        acc = None
        for wv in waves:
            w = wv["weights"]
            if wv["staleness"] is not None:
                w = w * torch.tensor(wv["staleness"], dtype=torch.float32, device=dev)
            acc = ota.aggregate_plain(wv["rows"], w, wv["gains"], acc=acc)
        err = (acc - last["acc"]).abs().max().item()
        # the counted rows as one wave == the barrier aggregate
        ocfg = ota.OTAConfig(snr_db=cfg.snr_db)
        wc, gc = last["weights"], last["gains"]
        one = ota.OtaAccumulator(srv.layout, ocfg).fold(
            rows, channel.combine_weights(wc, gc), gains=gc).accumulator
        ota.ota_aggregate_packed(last["draws"], rows, None, wc, srv.layout, ocfg, gains=gc)
        torch.cuda.synchronize()
        same = torch.equal(one, ota.ota_aggregate_packed.last_acc)
        print(f"    {len(waves)} waves re-folded with the plain versions: max_abs_err {err} "
              f"(tolerance: exact); one wave == barrier aggregate: {same}")
        if err != 0.0:
            _fail("stream accumulator differs from its plain re-fold")
        if not same:
            _fail("one-wave fold of the counted rows != ota_aggregate_packed")
    print(f"  launches during the stream rounds: {counts}")
    for n, c in counts.items():
        if c <= 0:
            _fail(f"{n} did not launch on the stream path")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(srv.params)):
        _fail("non-finite params after the stream rounds")
    return counts


# ---------------------------------------------------------------- phase 6

OPS_K, OPS_STD = 20, 0.1
# (x dtype, M) of each qmatmul case: a decode step at batch 4, the serve
# phase's 4 x 2,048 prefill and a ragged M in bf16 (the last two on the
# Hopper route); f32 at a decode step and a ragged M
QMM_CASES = (("bfloat16", 4), ("bfloat16", 8192), ("bfloat16", 1000), ("float32", 4),
             ("float32", 1000))
FQ_OPS_PER_ELEMENT = 8  # divide, round (or floor, subtract, compare, add), 2 clips, multiply


def _time_library(fn):
    """(CUDA-event ms, None) of a library call, or (None, the reason) where
    it does not run on these inputs; the port never calls it."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError, TypeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return cuda_ms(fn), None


# the cohort sizes of the chunked quantize-superpose (one launch takes at
# most 4,000 rows) at M = 262,144 columns: 8.4 GB of f32 rows at 8,000 (a
# full-width DeepSpeech2 row at K = 8,000 would be 132 GB, beyond the card)
QS_BIG_K, QS_BIG_M = (4001, 8000), 262_144
OPS_TOPK_K, ENGINE_BIG_K = 128, 300


def _remaining_ops_inputs(dev, n_ds2: int) -> dict:
    """Inputs of the reference's remaining ``ops`` names at DeepSpeech2
    width (K = 20 int4 rows of M = 4,133,952 symbols, blockwise scales,
    gains), the cosine top-k slab, the flash cases, the chunked
    quantize-superpose rows and a retrieval engine whose slab is on the
    card."""
    import numpy as np
    import torch

    from repro_torch.core import ota
    from repro_torch.retrieval import ArenaStore, RetrievalEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    K = OPS_K
    sym = torch.randint(-8, 8, (K, n_ds2), generator=gen, device=dev).to(torch.int8)
    nb = -(-n_ds2 // 256)
    inp = {
        "sym": sym,
        "scale": torch.rand((K, nb), generator=gen, device=dev) * 1e-3 + 1e-6,
        "w": torch.rand((K,), generator=gen, device=dev) / K,
        "gains": torch.rand((K,), generator=gen, device=dev),
        "acc": torch.randn((n_ds2,), generator=gen, device=dev),
        "flash": [(case, _flash_inputs(case, gen, dev)) for case in OPS_FLASH_CASES],
    }
    inp["topk"] = _topk_slab("int8", 4096, 3996, 256, gen, dev)
    bits = [(2, 4, 8, 16, 24, 31, 32)[i % 7] for i in range(max(QS_BIG_K))]
    X = torch.randn((max(QS_BIG_K), QS_BIG_M), generator=gen, device=dev) * 0.01
    scale, qmax = ota._client_grid(bits, X.abs().amax(dim=1))
    inp["qs"] = (X, scale, qmax, torch.rand((X.shape[0],), generator=gen, device=dev) / 4000,
                 0x5EED16)
    rng = np.random.RandomState(16)
    vec = rng.randn(2000, 64).astype(np.float32)
    store = ArenaStore(64, storage="f32", capacity=2048)
    store.add_batch(vec / np.linalg.norm(vec, axis=1, keepdims=True))
    inp["engine"] = RetrievalEngine(store, device=dev)
    inp["engine_q"] = np.ascontiguousarray(vec[:12] / np.linalg.norm(vec[:12], axis=1,
                                                                     keepdims=True))
    return inp


def _remaining_ops_calls(inp: dict) -> dict:
    """One call of each remaining ``ops`` name (the counted part)."""
    from repro_torch.kernels import ops

    packed = ops.pack_int4_rows(inp["sym"])
    kw = dict(gains=inp["gains"], qblock=256, packed4=True)
    out = {
        "packed": packed,
        "unpacked": ops.unpack_int4_rows(packed, inp["sym"].shape[1]),
        "superpose": ops.ota_dequant_superpose(packed, inp["scale"], inp["w"], **kw),
        "fold": ops.ota_fold_packed(inp["acc"], packed, inp["scale"], inp["w"], **kw),
        "topk": ops.topk_cosine(*inp["topk"], 3996, k=OPS_TOPK_K),
        "flash": [ops.flash_mha(q, k, v, causal=case[7]) for case, (q, k, v) in inp["flash"]],
    }
    X, scale, qmax, w, seed = inp["qs"]
    out["qs"] = [ops.ota_quantize_superpose(X[:K], scale[:K], qmax[:K], w[:K], seed)
                 for K in QS_BIG_K]
    eng, q = inp["engine"], inp["engine_q"]
    out["engine_small"] = eng.topk(q, 32)  # the slab goes to the card
    out["engine_big"] = eng.topk(q, ENGINE_BIG_K)
    return out


def _remaining_ops_launches(inp: dict) -> dict:
    return {"ota_superpose": 1, "ota_fold": 1, "topk_cosine": 2,
            "flash_attention": len(inp["flash"]),
            "ota_quantize_superpose": sum(-(-K // 4000) for K in QS_BIG_K)}


def _remaining_ops_checks(inp: dict, out: dict, dev):
    """Each result against its plain version (and the engine's large-k
    answer against the same engine on the CPU); times of the chunked
    quantize-superpose and the flash entry point. Returns (errs, timings)."""
    import torch

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk
    from repro_torch.retrieval import RetrievalEngine

    errs = {}
    sym, packed = inp["sym"], out["packed"]
    if packed.shape != (sym.shape[0], sym.shape[1] // 2) or not torch.equal(out["unpacked"],
                                                                              sym):
        _fail("pack_int4_rows / unpack_int4_rows do not round-trip the DeepSpeech2 symbols")
    kw = dict(gains=inp["gains"], qblock=256, packed4=True)
    sup_p = kota.superpose_plain(packed, inp["scale"], inp["w"], **kw)
    fold_p = kota.superpose_plain(packed, inp["scale"], inp["w"], acc=inp["acc"], **kw)
    errs["ota_superpose"] = (out["superpose"] - sup_p).abs().max().item()
    errs["ota_fold"] = (out["fold"] - fold_p).abs().max().item()
    print(f"  ota_dequant_superpose / ota_fold_packed: K={sym.shape[0]} int4 rows of "
          f"{sym.shape[1]} symbols (pack_int4_rows, {packed.numel()} B), qblock 256, gains: "
          f"max_abs_err {errs['ota_superpose']} / {errs['ota_fold']} (tolerance: exact)")
    if not (torch.equal(out["superpose"], sup_p) and torch.equal(out["fold"], fold_p)):
        _fail("ops.ota_dequant_superpose / ota_fold_packed != plain")
    qm, recs, scales = inp["topk"]
    s, i = out["topk"]
    sp, ip = ktk.topk_plain(qm, recs, scales, 3996, OPS_TOPK_K)
    errs["topk_cosine"] = (s - sp).abs().max().item()
    print(f"  topk_cosine: int8 slab 4096 x 256, n 3996, k {OPS_TOPK_K}: indices equal "
          f"{torch.equal(i, ip)}, max_abs_err {errs['topk_cosine']} (tolerance: exact)")
    if not (torch.equal(i, ip) and torch.equal(s, sp)):
        _fail("ops.topk_cosine != plain")
    timings = {"topk_cosine int8 Np=4096 n=3996 k=128": dict(
        ms=cuda_ms(lambda: ktk.topk_cosine(qm, recs, scales, 3996, k=OPS_TOPK_K)),
        ms_queued=cuda_ms_queued(lambda: ktk.topk_cosine(qm, recs, scales, 3996, k=OPS_TOPK_K)))}
    worst = 0.0
    for (case, (q, k, v)), o in zip(inp["flash"], out["flash"]):
        mm = kfa.mismatch(o, kfa.flash_attention_plain(q, k, v, causal=case[7]))
        worst = max(worst, mm["max_abs_err"])
        print(f"  ops.flash_mha {case[0]}: causal={case[7]} "
              f"design={kfa.kernel_design(q.dtype, q.shape[3])} {json.dumps(mm)} "
              f"{_flash_tol(q.dtype)}")
        if o.shape != q.shape or not mm["within"]:
            _fail(f"ops.flash_mha != plain beyond tolerance ({case[0]}): {mm}")
    errs["flash_attention"] = worst
    X, scale, qmax, w, seed = inp["qs"]
    worst = 0.0
    for K, (acc, ss) in zip(QS_BIG_K, out["qs"]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        acc_p, ss_p = kota.quantize_superpose_plain(X[:K], scale[:K], qmax[:K], w[:K], seed)
        end.record()
        end.synchronize()
        e = (acc - acc_p).abs().max().item()
        rel = abs(ss.item() - ss_p.item()) / abs(ss_p.item())
        worst = max(worst, e)
        print(f"  ota_quantize_superpose K={K} M={QS_BIG_M} ({4 * K * QS_BIG_M} B of rows, "
              f"{-(-K // 4000)} launches): acc max_abs_err {e} (tolerance: exact), sumsq rel "
              f"err {rel:.3e} (tolerance 1e-5)")
        if not torch.equal(acc, acc_p) or not torch.isfinite(acc).all() or rel > 1e-5:
            _fail(f"chunked quantize-superpose != plain at K={K}")
        wide = QS_BIG_M >= kota._QS_WIDE_M
        other = qs_other_layout(X[:K], scale[:K], qmax[:K], w[:K], seed, not wide, acc_p, ss_p)
        nbytes = tensor_bytes(X[:K], scale[:K], qmax[:K], w[:K]) + 4.0 * QS_BIG_M
        xt, ones, zeros = X[:K].t(), torch.ones_like(scale[:K]), torch.zeros_like(qmax[:K])
        timings[f"ota_quantize_superpose K={K}"] = dict(
            layout="wide" if wide else "narrow", **other,
            ms=cuda_ms(lambda: kota.ota_quantize_superpose(X[:K], scale[:K], qmax[:K], w[:K],
                                                           seed), reps=10),
            plain_ms=start.elapsed_time(end),
            **qs_bounds(nbytes, qmax[:K], QS_BIG_M),
            all32_ms=cuda_ms(lambda: kota.ota_quantize_superpose(X[:K], ones, zeros, w[:K],
                                                                 seed), reps=10),
            library_ms=cuda_ms(lambda: torch.mv(xt, w[:K]), reps=10),
            library="torch.mv(x.t(), w): the all-32-bit case")
    errs["ota_quantize_superpose"] = worst
    s_big, i_big = out["engine_big"]
    q = inp["engine_q"]
    s_cpu, i_cpu = RetrievalEngine(inp["engine"].store, device="cpu").topk(q, ENGINE_BIG_K)
    print(f"  RetrievalEngine.topk k={ENGINE_BIG_K} (slab on the card, 2000 x 64 f32): "
          f"{s_big.shape}, equal to the CPU engine: "
          f"{bool((i_big == i_cpu).all() and (s_big == s_cpu).all())}")
    if s_big.shape != (q.shape[0], ENGINE_BIG_K) or not ((i_big == i_cpu).all()
                                                           and (s_big == s_cpu).all()):
        _fail(f"RetrievalEngine.topk at k={ENGINE_BIG_K} misshapen or != the CPU engine")
    return errs, timings


HOST_CALLS, HOST_LOOPS = 1000, 5  # the host-time reading: the least of 5 loops of 1,000 calls


def host_us_per_call(dev) -> dict:
    """Host microseconds a call of each kernel wrapper takes on a small
    input (about 1,024 elements, or the smallest shape the kernel takes),
    beside one PyTorch call for the same function where there is one:
    HOST_CALLS calls timed with ``time.perf_counter`` around the loop and
    one ``torch.cuda.synchronize()`` at its end, the least of HOST_LOOPS
    such loops (other work on a shared host only adds to a loop). The
    device's work on these inputs is a few microseconds a call, so the loop
    reads the host."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk
    from repro_torch.kernels.ota_aggregate import ota_aggregate_2d
    from repro_torch.kernels.qmatmul import qmatmul
    from repro_torch.kernels.quantize import fake_quant_2d

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    x = rand(1024)
    s = x.abs().amax() / 127
    s_float = s.item()
    xk, wk, nz = rand(4, 256), rand(4), rand(256)
    xkt = xk.t()
    xq = rand(4, 64).to(torch.bfloat16)
    wq = (rand(64, 16) * 254 - 127).to(torch.int8)
    sq = rand(16)
    w_deq = (wq.float() * sq).to(torch.bfloat16)
    q8 = (rand(4, 256) * 254 - 127).to(torch.int8)
    qs_scale, qs_qmax = rand(4) * 1e-2 + 1e-3, torch.full((4,), 127.0, device=dev)
    recs = rand(256, 4)
    qm = rand(1, 4)
    fq, fk, fv = (rand(1, 32, 1, 32) for _ in range(3))
    ft = [t.transpose(1, 2).contiguous() for t in (fq, fk, fv)]
    cases = {
        "fake_quant": (lambda: fake_quant_2d(x, s, 8),
                       lambda: torch.fake_quantize_per_tensor_affine(x, s_float, 0, -127, 127),
                       "torch.fake_quantize_per_tensor_affine"),
        "ota_aggregate": (lambda: ota_aggregate_2d(xk, wk, nz, 0.1),
                          lambda: torch.addmv(nz, xkt, wk, beta=0.1), "torch.addmv"),
        "qmatmul": (lambda: qmatmul(xq, wq, sq), lambda: torch.matmul(xq, w_deq),
                    "torch.matmul"),
        "ota_superpose": (lambda: kota.ota_superpose(q8, wk, wk), None, None),
        "ota_fold": (lambda: kota.ota_fold(nz, q8, wk, wk), None, None),
        "ota_quantize_superpose": (
            lambda: kota.ota_quantize_superpose(xk, qs_scale, qs_qmax, wk, 7),
            lambda: torch.mv(xkt, wk), "torch.mv"),
        "topk_cosine": (lambda: ktk.topk_cosine(qm, recs, None, 256, k=1), None, None),
        "flash_attention": (lambda: kfa.flash_mha(fq, fk, fv),
                            lambda: F.scaled_dot_product_attention(*ft, is_causal=True),
                            "scaled_dot_product_attention"),
    }

    def per_call(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        loops = []
        for _ in range(HOST_LOOPS):
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            loops.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        return min(loops)

    out = {}
    for name, (fn, lib, lib_name) in cases.items():
        out[name] = {"us": per_call(fn), "library_us": None if lib is None else per_call(lib),
                     "library": lib_name}
    print(f"  host us per call (least of {HOST_LOOPS} loops of {HOST_CALLS} calls on ~1,024 "
          f"elements): {json.dumps(out)}")
    return out


def check_qmatmul_route_table(dev):
    """The C launcher's route (``qmatmul_design``) against ``kernel_design``
    over dtype, M at 16/17, K and N at and off TMA's multiples, and bases
    off 16-byte alignment."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.qmatmul import DESIGNS, kernel_design

    lib = _build.library("qmatmul")
    buf = torch.zeros(1 << 16, dtype=torch.float32, device=dev)
    w8 = torch.zeros(1 << 16, dtype=torch.int8, device=dev)
    n, hopper = 0, 0
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        xb = buf.to(dtype)
        for M in (4, 16, 17, 8192):
            for K in (64, 100, 4096, 4104):
                for N in (16, 24, 1008, 12288):
                    for xo, wo in ((0, 0), (1, 0), (0, 1), (8, 16)):
                        x, w = xb[xo:], w8[wo:]
                        got = DESIGNS[lib.qmatmul_design(code, M, N, K, x.data_ptr(),
                                                         w.data_ptr())]
                        want = kernel_design(dtype, M, N, K, x, w)
                        if got != want:
                            _fail(f"the C launcher routes {dtype} M={M} K={K} N={N} (offsets "
                                  f"{xo}, {wo}) to {got}; kernel_design says {want}")
                        n, hopper = n + 1, hopper + (got == "hopper")
    print(f"  qmatmul route table: C design() == kernel_design at {n} cases ({hopper} hopper)")


def phase_ops(dev):
    """The kernel entry points (``repro_torch.kernels.ops``) at the widths of
    the repository's models: fake-quant over every leaf of a DeepSpeech2
    update and a Qwen3-8B MLP weight, the OTA aggregate of 20 DeepSpeech2
    rows, and the weight-only int8/int4 matrix product at Qwen3-8B's MLP
    projections. The counters are zeroed just before the entry points run
    and read just after; the outputs are then held against the plain
    versions and the kernels timed."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk
    from repro_torch.kernels.ota_aggregate import ota_aggregate_2d, ota_aggregate_plain
    from repro_torch.kernels.qmatmul import TOL_C, kernel_design, mismatch, qmatmul_plain
    from repro_torch.kernels.qmatmul import qmatmul as qmm
    from repro_torch.kernels.quantize import fake_quant_2d, fake_quant_plain
    from repro_torch.models.layers import dense_init
    from repro_torch.models.registry import build_model

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    update = [torch.randn(t.shape, generator=gen, device=dev) * 0.01
              for t in tree_leaves(build_model(get_arch("deepspeech2")).init(gen, dev))]
    n_ds2 = sum(t.numel() for t in update)
    qwen = get_arch("qwen3-8b")
    d, f = qwen.d_model, qwen.d_ff
    weights = {"w_gate": dense_init(gen, (d, f), torch.bfloat16, dev),
               "w_down": dense_init(gen, (f, d), torch.bfloat16, dev)}
    X = torch.randn((OPS_K, n_ds2), generator=gen, device=dev) * 0.01
    n_k = torch.randint(50, 500, (OPS_K,), generator=gen, device=dev).to(torch.float32)
    w_avg = n_k / n_k.sum()  # FedAvg weights
    noise = torch.randn((n_ds2,), generator=gen, device=dev)
    xs = {(wn, dt, M): torch.randn((M, w.shape[0]), generator=gen, device=dev)
          .to(getattr(torch, dt)) for wn, w in weights.items() for dt, M in QMM_CASES}
    fq_gen = torch.Generator(device=dev)
    fq_gen.manual_seed(41)
    print(f"ops: DeepSpeech2 update {len(update)} leaves, {n_ds2} params; Qwen3-8B MLP "
          f"w_gate {tuple(weights['w_gate'].shape)}, w_down {tuple(weights['w_down'].shape)} "
          f"bf16; OTA K={OPS_K} x M={n_ds2}, std {OPS_STD}")
    if n_ds2 != 4_133_952:
        _fail(f"the DeepSpeech2 update has {n_ds2} params, want 4,133,952")

    rest = _remaining_ops_inputs(dev, n_ds2)
    names = ("fake_quant", "ota_aggregate", "qmatmul", "ota_superpose", "ota_fold",
             "topk_cosine", "flash_attention", "ota_quantize_superpose")
    wrappers = (fake_quant_2d, ota_aggregate_2d, qmm, kota.ota_superpose, kota.ota_fold,
                ktk.topk_cosine, kfa.flash_mha, kota.ota_quantize_superpose)
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fq = []  # (bits, stochastic, generator state before, outputs)
    for bits in (4, 8, 16):
        for stoch in (False, True):
            state = fq_gen.get_state()
            fq.append((bits, stoch, state, [ops.fake_quant(t, bits, stochastic=stoch,
                                                           generator=fq_gen) for t in update]))
    fq_qwen = ops.fake_quant(weights["w_gate"], 8)
    agg = ops.ota_aggregate(X, w_avg, noise, OPS_STD)
    quant = {wn: ops.quantize_weights(w) for wn, w in weights.items()}
    qmm_out = {key: ops.qmatmul(x, *quant[key[0]]) for key, x in xs.items()}
    p4, s4 = ops.quantize_weights_int4(weights["w_gate"])
    x4 = xs[("w_gate", "bfloat16", 4)]
    out4 = ops.qmatmul_int4(x4, p4, s4)
    rest_out = _remaining_ops_calls(rest)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in zip(names, wrappers)}
    print(f"  entry points: {secs:.3f} s, launches {counts}")
    want = {"fake_quant": 6 * len(update) + 1, "ota_aggregate": 1, "qmatmul": len(xs) + 1,
            **_remaining_ops_launches(rest)}
    if counts != want:
        _fail(f"ops launches {counts} != the calls made {want}")

    # fake-quant: the plain version on the same scale and the same noise
    err_fq = 0.0
    for bits, stoch, state, outs in fq:
        g2 = torch.Generator(device=dev)
        g2.set_state(state)
        for t, out in zip(update, outs):
            nz = (torch.rand(t.shape, generator=g2, dtype=torch.float32, device=dev)
                  if stoch else None)
            plain = fake_quant_plain(t, ops.fake_quant_scale(t, bits), bits, nz)
            if out.shape != t.shape or out.dtype != t.dtype or not torch.isfinite(out).all():
                _fail(f"fake_quant output misshapen or not finite (bits={bits}, stoch={stoch})")
            e = (out - plain).abs().max().item()
            err_fq = max(err_fq, e)
            if not torch.equal(out, plain):
                _fail(f"fake_quant kernel != plain: bits={bits} stochastic={stoch} "
                      f"leaf {tuple(t.shape)} err {e}")
    s_qwen = ops.fake_quant_scale(weights["w_gate"], 8)
    plain_qwen = fake_quant_plain(weights["w_gate"], s_qwen, 8)
    if fq_qwen.dtype != torch.bfloat16 or not torch.equal(fq_qwen, plain_qwen):
        _fail("fake_quant kernel != plain on the Qwen3-8B weight (bf16)")
    err_fq = max(err_fq, (fq_qwen.float() - plain_qwen.float()).abs().max().item())
    print(f"  fake_quant: {len(fq) * len(update)} DeepSpeech2 leaves (bits 4/8/16, nearest "
          f"and stochastic) + the Qwen3-8B w_gate (bf16, 8 bits): max_abs_err {err_fq} "
          f"(tolerance: exact)")

    agg_p = ota_aggregate_plain(X, w_avg, noise, OPS_STD)
    err_ota = (agg - agg_p).abs().max().item()
    print(f"  ota_aggregate: K={OPS_K} M={n_ds2}: max_abs_err {err_ota} (tolerance: exact)")
    if not torch.equal(agg, agg_p) or not torch.isfinite(agg).all():
        _fail(f"ota_aggregate kernel != plain: {err_ota}")

    err_qmm, worst_ratio = 0.0, 0.0
    qmm_checks = [(f"{wn} {dt} M={M}", out, xs[(wn, dt, M)], *quant[wn])
                  for (wn, dt, M), out in qmm_out.items()]
    qmm_checks.append(("w_gate int4 bf16 M=4", out4, x4, ops.unpack_int4(p4), s4))
    for label, out, x, q, s in qmm_checks:
        mm = mismatch(out, qmatmul_plain(x, q, s), x, q, s)
        err_qmm, worst_ratio = max(err_qmm, mm["max_abs_err"]), max(worst_ratio, mm["max_ratio"])
        M, K, N = x.shape[0], x.shape[1], q.shape[1]
        design = kernel_design(x.dtype, M, N, K, x, q)
        again = qmm(x, q, s)  # a second launch: the same bits
        mm["bit_stable"] = bool(torch.equal(again, out))
        print(f"  qmatmul {label} K={K} N={N} design={design}: {json.dumps(mm)} (tolerance "
              f"per element {TOL_C:g} sqrt(K) 2**-24 (|x| @ |w_deq|); two launches equal)")
        if out.shape != (M, N) or not mm["within"] or not mm["bit_stable"]:
            _fail(f"qmatmul kernel != plain beyond tolerance or not bit-stable ({label}): {mm}")
        del again
    check_qmatmul_route_table(dev)
    for bad in (
        lambda: fake_quant_2d(weights["w_gate"].half(), s_qwen, 8),
        lambda: ops.qmatmul(x4.t().contiguous().t(), *quant["w_gate"]),
        lambda: ops.ota_aggregate(X, w_avg, noise.double(), OPS_STD),
    ):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        _fail("an ops kernel wrapper accepted a float16, non-contiguous or float64 input")
    rest_errs, rest_timings = _remaining_ops_checks(rest, rest_out, dev)
    del rest, rest_out

    # timing on the inputs above
    timings = {}
    w_g = weights["w_gate"]
    nbytes = 2.0 * tensor_bytes(w_g)
    ops_n = float(FQ_OPS_PER_ELEMENT) * w_g.numel()
    lib_note = "torch.fake_quantize_per_tensor_affine on the bf16 weight"
    s_float = s_qwen.item()
    lib_ms, why = _time_library(
        lambda: torch.fake_quantize_per_tensor_affine(w_g, s_float, 0, -127, 127))
    if lib_ms is None:
        w_g32 = w_g.float()  # the copy is made here, not timed
        lib_note = f"torch.fake_quantize_per_tensor_affine on an f32 copy (bf16 refused: {why})"
        lib_ms, _ = _time_library(
            lambda: torch.fake_quantize_per_tensor_affine(w_g32, s_float, 0, -127, 127))
    timings["fake_quant"] = dict(
        shape=f"Qwen3-8B w_gate {tuple(w_g.shape)} bf16, 8 bits",
        ms=cuda_ms(lambda: fake_quant_2d(w_g, s_qwen, 8)),
        plain_ms=cuda_ms(lambda: fake_quant_plain(w_g, s_qwen, 8), reps=5),
        bound_ms=bound_ms(nbytes, ops_n), bound_by=bound_by(nbytes, ops_n),
        library_ms=lib_ms, library=lib_note)
    scales = [ops.fake_quant_scale(t, 8) for t in update]
    s_floats = [s_.item() for s_ in scales]
    nbytes = 2.0 * 4 * n_ds2
    ops_n = float(FQ_OPS_PER_ELEMENT) * n_ds2
    timings["fake_quant_ds2"] = dict(
        shape=f"every DeepSpeech2 update leaf ({len(update)} calls) f32, 8 bits, nearest",
        ms=cuda_ms(lambda: [fake_quant_2d(t, s_, 8) for t, s_ in zip(update, scales)]),
        plain_ms=cuda_ms(lambda: [fake_quant_plain(t, s_, 8) for t, s_ in zip(update, scales)],
                         reps=5),
        bound_ms=bound_ms(nbytes, ops_n), bound_by=bound_by(nbytes, ops_n),
        library_ms=_time_library(lambda: [torch.fake_quantize_per_tensor_affine(
            t, s_, 0, -127, 127) for t, s_ in zip(update, s_floats)])[0],
        library="torch.fake_quantize_per_tensor_affine per leaf")
    nbytes = tensor_bytes(X, w_avg, noise) + 4.0 * n_ds2
    ops_n = 2.0 * OPS_K * n_ds2 + 2.0 * n_ds2
    xt = X.t()
    lib = torch.addmv(noise, xt, w_avg, beta=OPS_STD)
    timings["ota_aggregate"] = dict(
        shape=f"K={OPS_K} M={n_ds2} f32",
        ms=cuda_ms(lambda: ota_aggregate_2d(X, w_avg, noise, OPS_STD)),
        plain_ms=cuda_ms(lambda: ota_aggregate_plain(X, w_avg, noise, OPS_STD), reps=5),
        bound_ms=bound_ms(nbytes, ops_n), bound_by=bound_by(nbytes, ops_n),
        library_ms=cuda_ms(lambda: torch.addmv(noise, xt, w_avg, beta=OPS_STD)),
        library="torch.addmv(noise, x.t(), w, beta=std)",
        library_rel_diff=((lib - agg).abs().max() / agg.abs().max()).item())
    for (wn, dt, M), x in xs.items():
        q, s = quant[wn]
        K, N = q.shape
        flops = 2.0 * M * N * K
        nbytes = tensor_bytes(x, q, s) + 4.0 * M * N
        peak = BF16_FLOPS if dt == "bfloat16" else F32_FLOPS
        w_deq = (q.float() * s).to(x.dtype)  # dequantized beforehand, not timed
        rec = dict(
            shape=f"{wn} x {dt} M={M} K={K} N={N}", design=kernel_design(x.dtype, M, N, K, x, q),
            ms=cuda_ms(lambda: qmm(x, q, s)),
            ms_queued=cuda_ms_queued(lambda: qmm(x, q, s)),
            plain_ms=cuda_ms(lambda: qmatmul_plain(x, q, s), reps=3),
            bound_ms=bound_ms(nbytes, flops, peak), bound_by=bound_by(nbytes, flops, peak),
            library_ms=cuda_ms(lambda: torch.matmul(x, w_deq)),
            library_ms_queued=cuda_ms_queued(lambda: torch.matmul(x, w_deq)),
            library=f"torch.matmul on weights dequantized to {dt} beforehand (not timed)")
        rec["tflops_queued"] = flops / rec["ms_queued"] / 1e9
        rec["of_bound_queued"] = rec["bound_ms"] / rec["ms_queued"]
        rec["library_of_bound_queued"] = rec["bound_ms"] / rec["library_ms_queued"]
        if dt == "bfloat16" and M == 4:
            qt = q.t().contiguous()
            s16 = s.to(x.dtype)
            rec["int8pack_ms"], rec["int8pack_note"] = _time_library(
                lambda: torch._weight_int8pack_mm(x, qt, s16))
        del w_deq
        timings[f"qmatmul {wn} {dt} M={M}"] = rec
    w_unpacked = ops.unpack_int4(p4)
    timings["qmatmul_int4 w_gate bfloat16 M=4"] = dict(
        ms=cuda_ms(lambda: ops.qmatmul_int4(x4, p4, s4)),
        kernel_only_ms=cuda_ms(lambda: qmm(x4, w_unpacked, s4)))
    for name, rec in timings.items():
        print(f"  ops timing {name}: " + json.dumps(rec))
    errs = {"fake_quant": err_fq, "ota_aggregate": err_ota, "qmatmul": err_qmm, **rest_errs}
    rows = {"fake_quant": timings["fake_quant"], "ota_aggregate": timings["ota_aggregate"],
            "qmatmul": timings["qmatmul w_gate bfloat16 M=4"]}
    for name, rec in rest_timings.items():
        print(f"  ops timing {name}: " + json.dumps(rec))
    del fq, qmm_out, xs, X, update, weights, quant
    torch.cuda.empty_cache()
    return counts, errs, rows


# ---------------------------------------------------------------- phase 7

SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# max |log_softmax(flash) - log_softmax(chunked)| over the last-position
# logits. Both paths compute the same attention in bf16 with f32
# accumulation; they round p to bf16 against different running maxima
# (128-key tiles vs 1024-key chunks), so each layer's attention output can
# differ by a bf16 rounding, and the logits leave the head in bf16. On an
# H100 (``scripts/flash_tolerance_probe.py``, these weights and prompts) the
# kernel read 0.066 and the plain version 0.072; with a planted fault in
# place of the kernel, an unrescaled key tile read 0.58, a dropped key tile
# 0.80 and a mask one key ahead 1.55. The bound sits near the geometric
# middle of 0.072 and 0.58. Faults of precision alone (p left in f32, the
# scale rounded to bf16) read 0.071-0.072 here: the kernels phase's share
# bound catches those, not this check.
SERVE_LOGIT_TOL = 0.2


def _host_share(cfg, params, res, dev):
    """Host-clock time to enqueue one flash prefill and one decode step
    (the call returns once every launch is queued) beside the same call
    synchronised: where the two are close, the host's dispatch of the eager
    ops bounds the step and the card waits."""
    import torch

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.registry import build_model

    model = build_model(cfg)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    batch = {"tokens": torch.as_tensor(res.prompts, dtype=torch.int32, device=dev)}
    cache = model.grow_cache(res.cache, SERVE_PROMPT + SERVE_GEN)
    step = {"tokens": res.tokens[:, -1:].contiguous(),
            "pos": torch.full((SERVE_BATCH,), SERVE_PROMPT + SERVE_GEN - 1, dtype=torch.int32,
                              device=dev)}
    out = {}
    for name, fn in (("prefill", lambda: prefill(params, batch)),
                     ("decode", lambda: decode(params, cache, step))):
        enq, tot = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enq.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            tot.append(time.perf_counter() - t0)
        out[f"{name}_enqueue_ms"] = statistics.median(enq) * 1e3
        out[f"{name}_synced_ms"] = statistics.median(tot) * 1e3
    print(f"  host enqueue vs synchronised (median of 3): {json.dumps(out)}")
    return out


def phase_serve(dev):
    """Qwen3-8B at full width through the serving driver (flash prefill,
    cache growth, greedy decode), the same prefill through the plain
    chunked attention, and the continuous-batching engine."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_arch("qwen3-8b").with_(use_flash_kernel=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = build_model(cfg).init(gen, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"serve: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim()}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}: {n_params} params, init "
          f"{time.perf_counter() - t0:.2f} s")
    if n_params != 8_190_735_360:
        _fail(f"qwen3-8b has {n_params} params, want 8,190,735,360")
    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, seed=0, device=dev, params=params)
    serve(cfg, gen=2, **kw)  # warm-up: cuBLAS handles, first launches

    kfa.flash_mha.launches = 0
    res = serve(cfg, gen=SERVE_GEN, **kw)
    launches = kfa.flash_mha.launches
    toks = res.tokens.cpu().numpy()
    print(f"  flash prefill B={SERVE_BATCH} S={SERVE_PROMPT}: {res.prefill_s * 1e3:.1f} ms "
          f"(cache grown to {SERVE_PROMPT + SERVE_GEN}); decode {SERVE_GEN - 1} steps: "
          f"{res.decode_s / (SERVE_GEN - 1) * 1e3:.2f} ms/token; flash launches {launches}")
    print(f"  sample token ids: {toks[0, :16].tolist()} / {toks[1, :8].tolist()}")
    if launches != cfg.n_layers:
        _fail(f"flash prefill launched the kernel {launches} times, want {cfg.n_layers}")
    if not res.all_finite or toks.shape != (SERVE_BATCH, SERVE_GEN):
        _fail("serve logits not finite or tokens misshapen")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        _fail("token ids out of the vocabulary")

    plain = serve(cfg.with_(use_flash_kernel=False), gen=1, **kw)
    if kfa.flash_mha.launches != launches:
        _fail("the chunked prefill launched the flash kernel")
    lf = torch.log_softmax(res.prefill_logits, -1)
    lc = torch.log_softmax(plain.prefill_logits, -1)
    dmax = float((lf - lc).abs().max())
    top2 = plain.prefill_logits.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (res.prefill_logits.argmax(-1) == plain.prefill_logits.argmax(-1)).tolist()
    print(f"  chunked prefill: {plain.prefill_s * 1e3:.1f} ms; flash vs chunked max "
          f"|d log_softmax| {dmax!r} (tolerance {SERVE_LOGIT_TOL}), top-1 agree {agree}, "
          f"chunked top-2 margins "
          f"{[round(m, 4) for m in margin]}")
    if not dmax <= SERVE_LOGIT_TOL:
        _fail(f"flash and chunked prefill disagree: {dmax} > {SERVE_LOGIT_TOL}")
    if any(not a and m > 2 * SERVE_LOGIT_TOL for a, m in zip(agree, margin)):
        _fail("flash and chunked prefill pick different top-1 tokens away from a near tie")
    timing = {"prefill_ms": res.prefill_s * 1e3, "chunked_prefill_ms": plain.prefill_s * 1e3,
              "decode_ms_per_token": res.decode_s / (SERVE_GEN - 1) * 1e3}
    timing.update(_host_share(cfg, params, res, dev))
    del res, plain

    sharded = _serve_sharded(cfg, params, dev, fault=SERVE_SHARDED[1][1], bitwise=(2, 1))
    for r in sharded["runs"]:
        print(f"  sharded {r['route']} {tuple(r['mesh'])}: prefill {r['prefill_ms']:.1f} ms, "
              f"decode {r['decode_ms_per_token']:.2f} ms/token (unsharded this run "
              f"{timing['prefill_ms']:.1f} / {timing['decode_ms_per_token']:.2f}; recorded "
              f"{SERVE_UNSHARDED_RECORDED['prefill_ms']} / "
              f"{SERVE_UNSHARDED_RECORDED['decode_ms_per_token']}); flash launches "
              f"{r['flash_launches']} (2 prefills); gathers {r['gather_bytes_per_token']} B a "
              f"token; cache {r['cache_bytes_a_device'][0]} B a device (reckoned "
              f"{r['cache_bytes_reckoned']}); max |d log_softmax| "
              f"{max(r['max_dlogsoftmax'])!r} (bound {TP_SERVE_LOGIT_TOL})")

    eng = ServeEngine(cfg, max_batch=4, cache_len=256, device=dev, params=params)
    rng = np.random.RandomState(1)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, size=rng.randint(16, 65)).astype(np.int32),
                    max_new_tokens=int(rng.randint(8, 25))) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = eng.stats()
    prompt_toks = sum(len(r.prompt) for r in reqs)
    print(f"  engine: 8 requests (prompts {prompt_toks} tokens, 16-64 each; "
          f"8-24 new), max_batch 4, cache_len 256: {secs:.2f} s, stats {json.dumps(st)}")
    if len(done) != 8 or st["completed"] != 8:
        _fail(f"the engine completed {len(done)} of 8 requests")
    if any(not (1 <= len(r.generated) <= r.max_new_tokens) for r in done):
        _fail("a request generated a token count outside 1..max_new_tokens")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  peak device memory {peak} B")
    del eng, params
    torch.cuda.empty_cache()
    vlm = _serve_vlm_sharded(dev)
    fam = _serve_tp_families(dev)
    new = sharded["flash_launches"] + vlm["flash_launches"] + fam["flash_launches"]
    print(f"  sharded serve: {sharded['s']:.1f} s for {cfg.name}, {vlm['s']:.1f} s for "
          f"{SERVE_VLM[0]}, {fam['s']:.1f} s for {', '.join(TP_FAMILIES)}; flash launches of "
          f"their prefill runs {sharded['flash_launches']} + {vlm['flash_launches']} + "
          f"{fam['flash_launches']}")
    return dict(timing, launches=launches + new, serve_launches=launches,
                sharded_launches=new,
                flash_max_abs_err=max(sharded["flash_max_abs_err"], vlm["flash_max_abs_err"],
                                      fam["flash_max_abs_err"]),
                prompt_tokens=prompt_toks, engine_s=secs, max_dlogsoftmax=dmax,
                peak_bytes=peak, sharded=sharded, vlm=vlm, families=fam)


# the sharded prefill and decode (``launch.steps.make_sharded_prefill_step``
# and ``make_sharded_decode_step``) in the serve phase: (route, mesh) on
# meshes of four shards of the card, each a prefill (timed the second time)
# and SERVE_GEN - 1 decode steps fed the unsharded run's greedy tokens
SERVE_SHARDED = (("gather", (2, 2)), ("tp", (2, 2)), ("tp", (1, 4)))
# max |d log_softmax| of each step's logits against the unsharded flash
# prefill and decode on the same tokens. Readings (an NVIDIA H100 80GB
# HBM3 at 700 W, run 1 of the slice): honest 0.0625-0.0787 on every mesh
# and route (qwen2-vl 0.0549-0.0703: one bf16 rounding of a logit near 10
# is 0.0625), the planted dropped partial 5.71-6.32 from the prefill on.
# The geometric middle (0.67) is looser than SERVE_LOGIT_TOL, so the bound
# is that.
TP_SERVE_LOGIT_TOL = SERVE_LOGIT_TOL
SERVE_FAULT_STEPS = 4  # decode steps of the planted fault's run
# qwen2-vl-2b on (1, 4): its 2 kv heads do not divide 4 (a replicated
# cache), q/k/v biases, M-RoPE and the reference serve flow's zero patches
SERVE_VLM = ("qwen2-vl-2b", (1, 4), 8)
# the unsharded Qwen3-8B serve as PERF.md section 5 records it
SERVE_UNSHARDED_RECORDED = {"prefill_ms": 277.0, "decode_ms_per_token": 47.85}


def _serve_unsharded_tf(model, params, batch, gen: int, P: int, dev):
    """The unsharded flash prefill (a warm-up call, then the timed one) and
    ``gen - 1`` greedy decode steps, timed together: (each step's
    log_softmax on the card, the tokens (B, gen - 1) each step was fed,
    {"prefill_ms", "decode_ms_per_token"})."""
    import torch

    from repro_torch.launch import steps

    B = batch["tokens"].shape[0]
    prefill = steps.make_prefill_step(model)
    prefill(params, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill(params, batch)
    torch.cuda.synchronize()
    times = {"prefill_ms": (time.perf_counter() - t0) * 1e3}
    cache = model.grow_cache(cache, P + gen)
    decode = steps.make_decode_step(model)
    want, fed = [torch.log_softmax(lg, -1)], []
    t0 = time.perf_counter()
    for s in range(gen - 1):
        tok = torch.argmax(lg, dim=-1).to(torch.int32).reshape(B, 1)
        fed.append(tok)
        lg, cache = decode(params, cache, {"tokens": tok, "pos": torch.full(
            (B,), P + s, dtype=torch.int32, device=dev)})
        want.append(torch.log_softmax(lg, -1))
    torch.cuda.synchronize()
    times["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / (gen - 1)
    del cache
    return want, torch.cat(fed, dim=1), times


def _serve_sharded_run(model, params, batch, fed, want, P: int, dims, tp: bool, dev, *,
                       steps_n=None, fault=False, keep=False, timed=True) -> dict:
    """One sharded run on a ``dims`` ("data", "model") mesh of four (or
    two) shards of the card: the params placed by the specs, a traced
    prefill (its spans, the flash launches; one launch of each distinct
    shape held against ``flash_attention_plain`` on the same inputs), a
    timed one (launches counted too; ``timed`` False: the traced one
    alone), ``grow_placed_cache``, then ``steps_n`` decode steps fed
    ``fed`` (all of them by default), timed together; each step's max |d
    log_softmax| against ``want``, after the timed steps; the cache's
    bytes a device against
    ``cache_spec``'s reckoning, its pieces written in place, and the bytes
    each step gathers of the params (the data-split pieces, reckoned from
    the specs as the train phase's). ``fault`` drops model shard 1's
    partial from every row-parallel sum; ``keep`` returns the logits and
    the cache."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    cfg = model.cfg
    B = batch["tokens"].shape[0]
    steps_n = fed.shape[1] if steps_n is None else steps_n
    mesh = make_mesh(dims, ("data", "model"), devices=[dev] * (dims[0] * dims[1]))
    p_specs = shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads)
    p_sh = shd.to_named(p_specs, mesh)
    placed = shd.place(params, p_sh)
    torch.cuda.empty_cache()
    b_sh = shd.to_named(shd.batch_spec(batch, mesh), mesh)
    prefill = steps.make_sharded_prefill_step(model, p_sh, b_sh, tensor_parallel=tp)
    out = {"mesh": list(dims), "route": "tensor_parallel" if tp else "gather"}
    ctx = _DropPartial() if fault else contextlib.nullcontext()
    seen, real = {}, layers.flash_mha

    def flash(q, k, v, *, causal=True):  # keeps one call of each shape
        o = real(q, k, v, causal=causal)
        seen.setdefault((tuple(q.shape), tuple(k.shape), q.dtype, causal), (q, k, v, o))
        return o

    with ctx:
        kfa.flash_mha.launches = 0
        layers.flash_mha = flash
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with obs.enabled() as tracer:
                lg, cache = prefill(placed, batch)
            torch.cuda.synchronize()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3  # the traced call's
        finally:
            layers.flash_mha = real
        out["flash_checks"] = []
        for (qs, ks, dt, causal), (q, k, v, o) in seen.items():
            mm = kfa.mismatch(o, kfa.flash_attention_plain(q, k, v, causal=causal))
            out["flash_checks"].append(dict(q=list(qs), kv=list(ks), **mm))
            if not mm["within"]:
                _fail(f"row 7 on the sharded prefill's shards ({out['route']} {dims}) != its "
                      f"plain version at q {qs}, k/v {ks}: {mm} {_flash_tol(dt)}")
        seen.clear()
        spans = [e.args["kind"] for e in tracer.events if e.name == "tensor_parallel"]
        out["prefill_spans"] = {k: spans.count(k) for k in sorted(set(spans))}
        if timed:
            del cache
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = prefill(placed, batch)
            torch.cuda.synchronize()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["flash_launches"] = kfa.flash_mha.launches
        cache = steps.grow_placed_cache(model, cache, P + fed.shape[1] + 1)
        c_sh = {k: v.sharding for k, v in cache.items()}
        step0 = {"tokens": fed[:, :1], "pos": torch.full((B,), P, dtype=torch.int32,
                                                           device=dev)}
        decode = steps.make_sharded_decode_step(
            model, p_sh, c_sh, shd.to_named(shd.batch_spec(step0, mesh), mesh),
            tensor_parallel=tp)
        ptrs = [p.data_ptr() for leaf in cache.values() for p in leaf.pieces.flat]
        logits = [lg]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.enabled() as tracer:
            for s in range(steps_n):
                lg, _ = decode(placed, cache, {"tokens": fed[:, s:s + 1].contiguous(),
                                               "pos": torch.full((B,), P + s, dtype=torch.int32,
                                                                 device=dev)})
                logits.append(lg)
        torch.cuda.synchronize()
        out["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / steps_n
        gaps = [(torch.log_softmax(g, -1) - w).abs().amax() for g, w in zip(logits, want)]
    events = tracer.events
    kinds = [e.args["kind"] for e in events if e.name == "tensor_parallel"]
    out["decode_spans_per_step"] = {k: kinds.count(k) / steps_n for k in sorted(set(kinds))}
    copies = [(e.args["leaf"], e.args["bytes"]) for e in events if e.name == "cache_copy"]
    out["cache_copies_per_step"] = len(copies) / steps_n
    out["cache_copy_bytes_per_step"] = {
        leaf: sum(b for n, b in copies if n == leaf) / steps_n for leaf in sorted({n for n, _ in copies})}
    out["max_dlogsoftmax"] = [float(g) for g in gaps]
    out["in_place"] = ptrs == [p.data_ptr() for leaf in cache.values() for p in leaf.pieces.flat]
    # pieces of one box (a leaf replicated over "model") hold the same bits
    out["replicas_equal"] = all(
        _same_bits(leaf.pieces[i], leaf.pieces[j]) for leaf in cache.values()
        for i in np.ndindex(leaf.pieces.shape) for j in np.ndindex(leaf.pieces.shape)
        if i < j and leaf.bounds(i) == leaf.bounds(j))
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in cache.items()}
    out["cache_bytes_a_device"] = [int(b) for b in shd.device_nbytes(cache).flat]
    out["cache_bytes_reckoned"] = shd.tree_spec_nbytes(shapes, shd.cache_spec(shapes, mesh), mesh)
    out["cache_specs"] = {k: repr(v.sharding.spec) for k, v in cache.items()}
    shapes_p = model.init(None, torch.device("meta"))
    dp = dims[0]
    out["gather_bytes_per_token"] = dp * _read_copy_bytes(shapes_p, p_specs, mesh, cfg, tp)
    out["param_bytes_a_device"] = shd.tree_spec_nbytes(shapes_p, p_specs, mesh)
    if keep:
        out["logits"], out["cache"] = logits, cache
    del placed, cache
    torch.cuda.empty_cache()
    return out


def _serve_sharded(cfg, params, dev, *, patches: int = 0, runs=SERVE_SHARDED, fault=None,
                   bitwise=None, prompt: int = SERVE_PROMPT, gather_steps=None,
                   tol: float = TP_SERVE_LOGIT_TOL, timed: bool = True) -> dict:
    """The sharded prefill and decode of ``cfg`` (flash on) on ``params``:
    the unsharded run's greedy tokens fed to each ``runs`` (route, mesh)
    run, each held within ``tol`` of the unsharded run's
    log_softmax at every step; with ``fault`` (a mesh) the tensor-parallel
    run there with a dropped partial, which must break the bound; with
    ``bitwise`` (a mesh without a model axis) both routes' prefill, two
    decode steps and cache pieces bit for bit. The prompt is ``prompt``
    tokens (an audio model's batch also holds ``encoder_seq`` random
    frames); a gather-route run takes ``gather_steps`` decode steps (all
    by default); with ``timed`` False each run's prefill ms are its traced
    call's. Returns the readings and the flash launches of every prefill
    run."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.registry import build_model

    t_part = time.perf_counter()
    model = build_model(cfg)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt))
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int32, device=dev)}
    if patches:
        batch["patches"] = torch.zeros((SERVE_BATCH, patches, cfg.frontend_dim),
                                       dtype=torch.float32, device=dev)
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(
            rng.randn(SERVE_BATCH, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32),
            device=dev)
    P = prompt
    kfa.flash_mha.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, fed, times = _serve_unsharded_tf(model, params, batch, SERVE_GEN, P, dev)
    torch.cuda.synchronize()
    launches = kfa.flash_mha.launches
    res = {"unsharded_prefill_and_decode_s": time.perf_counter() - t0, "unsharded": times,
           "runs": []}
    checks = []  # every run's row 7 checks against the plain version
    for route, dims in runs:
        r = _serve_sharded_run(model, params, batch, fed, want, P, dims, route == "tp", dev,
                               steps_n=None if route == "tp" else gather_steps, timed=timed)
        launches += r["flash_launches"]
        checks += r["flash_checks"]
        res["runs"].append(r)
        print(f"  sharded {cfg.name} {route} {dims}: " + json.dumps(r))
    broken = [(r["route"], r["mesh"]) for r in res["runs"]
              if not max(r["max_dlogsoftmax"]) <= tol]
    if fault is not None:
        f = _serve_sharded_run(model, params, batch, fed, want, P, fault, True, dev,
                               steps_n=SERVE_FAULT_STEPS, fault=True, timed=False)
        launches += f["flash_launches"]
        checks += f["flash_checks"]
        res["fault"] = f["max_dlogsoftmax"]
        print(f"  planted fault (model shard 1's partial dropped from every row-parallel sum) "
              f"on {fault}: max |d log_softmax| by step {json.dumps(f['max_dlogsoftmax'])}")
        if not f["max_dlogsoftmax"][0] > tol:
            _fail(f"the bound {tol} does not catch a dropped partial in the "
                  f"sharded prefill: {f['max_dlogsoftmax']}")
    if bitwise is not None:
        outs = []
        for tp in (False, True):
            r = _serve_sharded_run(model, params, batch, fed, want, P, bitwise, tp, dev,
                                   steps_n=2, keep=True, timed=False)
            launches += r["flash_launches"]
            checks += r["flash_checks"]
            outs.append(r)
        same = all(_same_bits(a, b) for a, b in zip(outs[0]["logits"], outs[1]["logits"]))
        pieces = all(_same_bits(p, q) for name in outs[0]["cache"]
                     for p, q in zip(outs[0]["cache"][name].pieces.flat,
                                     outs[1]["cache"][name].pieces.flat))
        res["bitwise"] = same and pieces
        print(f"  {bitwise} mesh: the tensor-parallel route's prefill, 2 decode steps and cache "
              f"pieces bit for bit the gather route's: logits {same}, pieces {pieces}")
        del outs
        torch.cuda.empty_cache()
        if not res["bitwise"]:
            _fail(f"on a {bitwise} mesh the tensor-parallel serve differs from the gather route")
    kind, per_shard = _tp_layer_kind(cfg)
    for r in res["runs"]:
        dp, mp = r["mesh"]
        tp = r["route"] == "tensor_parallel"
        heads_split = tp and cfg.n_heads % mp == 0
        prefills = 2 if timed else 1  # the traced call, and the timed one
        want_l = prefills * _flash_launches(cfg) * dp * (mp if heads_split else 1)
        if r["flash_launches"] != want_l:
            _fail(f"the sharded prefills on {r['mesh']} ({r['route']}) launched the flash kernel "
                  f"{r['flash_launches']} times, want {want_l}")
        if tp and r["prefill_spans"].get(kind) != dp * per_shard:
            _fail(f"the tensor-parallel prefill on {r['mesh']} took {r['prefill_spans']} spans")
        if not r["in_place"] or not r["replicas_equal"] or any(
                b != r["cache_bytes_reckoned"] for b in r["cache_bytes_a_device"]):
            _fail(f"the sharded cache on {r['mesh']} ({r['route']}) is not cache_spec's pieces "
                  f"written in place: {r['cache_bytes_a_device']}, in place {r['in_place']}")
    if broken:
        _fail(f"the sharded serve differs from the unsharded one beyond {tol}: "
              f"{broken}")
    res["flash_launches"] = launches
    res["flash_max_abs_err"] = max((c["max_abs_err"] for c in checks), default=0.0)
    print(f"  row 7 on the shards' heads against its plain version, one launch a shape: "
          + json.dumps([{k: c[k] for k in ("q", "kv", "max_abs_err", "within")} for c in checks]))
    res["s"] = time.perf_counter() - t_part
    return res


def _tp_layer_kind(cfg):
    """The tensor-parallel block a prefill runs once a layer a data shard
    on the tensor-parallel route, and how many times: the attention of the
    transformer families, the Mamba block of ssm and hybrid, the MLP of
    audio (its encoder's and decoder's; the attentions read whole where
    the heads do not divide)."""
    if cfg.family in ("ssm", "hybrid"):
        return ("mamba1" if cfg.family == "ssm" else "mamba2"), cfg.n_layers
    if cfg.family == "audio":
        return "mlp", cfg.n_layers + cfg.encoder_layers
    return "attn", cfg.n_layers


def _serve_vlm_sharded(dev) -> dict:
    """qwen2-vl-2b at full depth (flash on) on the tensor-parallel route of
    ``SERVE_VLM``'s mesh against its unsharded run: 2 kv heads over 4
    model shards, so every shard's cache piece holds both kv heads, and
    every replica must be equal after the last step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model

    arch, dims, patches = SERVE_VLM
    cfg = get_arch(arch).with_(use_flash_kernel=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = build_model(cfg).init(gen, dev)
    res = _serve_sharded(cfg, params, dev, patches=patches, runs=(("tp", dims),))
    del params
    torch.cuda.empty_cache()
    return res


# the ssm, hybrid and audio families on the sharded serve's routes (the
# serve phase, after qwen3-8b and qwen2-vl-2b): each at full width and
# depth (flash on), a prefill of SERVE_BATCH x TP_FAM_PROMPT tokens
# (whisper's over encoder_seq random frames a row), SERVE_GEN - 1 decode
# steps fed the unsharded run's greedy tokens on each tensor-parallel mesh,
# the gather route on (2, 2) with TP_FAM_GATHER_STEPS decode steps (its
# times), and the planted fault on (2, 2), each step held within
# TP_FAM_SERVE_LOGIT_TOL of the unsharded run
TP_FAMILIES = ("falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny")
TP_FAM_PROMPT = 256
# max |d log_softmax| of each step against the unsharded run, between the
# honest runs' readings and the planted fault's (every row-parallel sum
# without model shard 1's partial), in brackets (an NVIDIA H100 80GB HBM3
# at 700 W): the tensor-parallel route rounds each layer's f32 partial
# sums to bf16 once where the unsharded block rounds its bf16 products,
# over 64 layers for falcon-mamba and 54 for zamba2 [falcon-mamba
# 0.207-0.276, zamba2 0.208-0.317 (its gather route 0.123), whisper
# 0.031-0.032; faults 5.53-6.17, 5.14-6.24, 3.44-3.58]; 1.0 is near the
# geometric middle of 0.317 and 3.44
TP_FAM_SERVE_LOGIT_TOL = 1.0
TP_FAM_GATHER_STEPS = 8
# the cache leaves a tensor-parallel decode step may read into a copy, on
# (2, 2) and on (1, 4): every other unit's box is its own piece, written
# in place (the hybrid's head-split ssm_h has pieces cut on P; on (2, 2)
# cache_spec puts "data" on its ssm_conv's layer axis and on enc_out's
# frames)
TP_FAM_COPIES = {"falcon-mamba-7b": ((), ()), "zamba2-2.7b": (("ssm_h", "ssm_conv"), ("ssm_h",)),
                 "whisper-tiny": (("enc_out",), ())}


def _serve_tp_families(dev) -> dict:
    """``TP_FAMILIES`` one after the other through ``_serve_sharded``
    (params from seed 0): each tensor-parallel run's copied cache leaves
    held to ``TP_FAM_COPIES``, its bytes a device of params and cache the
    specs'. Returns each model's readings and the flash launches and
    worst row 7 error of every prefill run."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model

    out = {"flash_launches": 0, "flash_max_abs_err": 0.0, "models": {}}
    t0 = time.perf_counter()
    for arch in TP_FAMILIES:
        cfg = get_arch(arch).with_(use_flash_kernel=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = build_model(cfg).init(gen, dev)
        res = _serve_sharded(cfg, params, dev, fault=(2, 2), prompt=TP_FAM_PROMPT,
                             gather_steps=TP_FAM_GATHER_STEPS, tol=TP_FAM_SERVE_LOGIT_TOL,
                             timed=False)
        del params
        torch.cuda.empty_cache()
        allowed = dict(zip(((2, 2), (1, 4)), TP_FAM_COPIES[arch]))
        for r in res["runs"]:
            print(f"  {arch} {r['route']} {tuple(r['mesh'])}: prefill {r['prefill_ms']:.1f} ms, "
                  f"decode {r['decode_ms_per_token']:.2f} ms/token (unsharded "
                  f"{res['unsharded']['prefill_ms']:.1f} / "
                  f"{res['unsharded']['decode_ms_per_token']:.2f}); "
                  f"spans {json.dumps(r['prefill_spans'])} / step "
                  f"{json.dumps(r['decode_spans_per_step'])}; copied B a step "
                  f"{json.dumps(r['cache_copy_bytes_per_step'])}; params "
                  f"{r['param_bytes_a_device']} B and cache {r['cache_bytes_a_device'][0]} B a "
                  f"device; gathers {r['gather_bytes_per_token']} B a token; max |d "
                  f"log_softmax| {max(r['max_dlogsoftmax'])!r}")
            if r["route"] == "tensor_parallel" and not set(
                    r["cache_copy_bytes_per_step"]) <= set(allowed[tuple(r["mesh"])]):
                _fail(f"{arch}'s tensor-parallel decode on {r['mesh']} copied "
                      f"{r['cache_copy_bytes_per_step']}: its own pieces must be written in place")
        out["flash_launches"] += res["flash_launches"]
        out["flash_max_abs_err"] = max(out["flash_max_abs_err"], res["flash_max_abs_err"])
        out["models"][arch] = res
    out["s"] = time.perf_counter() - t0
    print(f"  tensor-parallel families serve: {out['s']:.1f} s, flash launches "
          f"{out['flash_launches']}")
    return out


# ---------------------------------------------------------------- phase 8b

# (arch, layers kept, params, parameter bytes): full width, depth cut to
# what one card holds (a kimi-k2 layer is 17.03e9 params, 34.1 GB; an
# arctic layer 13.61e9, 27.2 GB); qwen2-vl-2b, falcon-mamba-7b,
# zamba2-2.7b and whisper-tiny (4 decoder and 4 encoder layers) at full
# depth. Arctic keeps two layers so that a second layer's attention runs
# over MoE outputs.
FAMILIES = (("kimi-k2-1t-a32b", 1, 19_378_623_488, 38_762_752_000),
            ("arctic-480b", 2, 27_681_131_520, 55_365_933_056),
            ("qwen2-vl-2b", 28, 1_779_447_296, 3_558_894_592),
            ("falcon-mamba-7b", 64, 7_272_665_088, 14_564_204_544),
            ("zamba2-2.7b", 54, 2_435_777_440, 4_871_580_800),
            ("whisper-tiny", 4, 61_221_888, 122_443_776))
# init draws each leaf a slab at a time: its peak may pass the params' own
# bytes by at most this much
INIT_HEADROOM_BYTES = 4 * 2**30
VLM_PATCHES = 8  # the reference serve flow's zero patch embeddings


# f32 operations of the Mamba-1 chunked scan per (token, channel, state):
# pass 1 exp(dt A) (2), the input term (1), h = a h + b (2), the decay
# product (1); pass 3 the same but the product (5) and y's contraction (2)
MAMBA1_SCAN_OPS = 13
SSD_CHUNK = 64  # models/ssm._ssd_scan's default chunk


def _ssd_f32_flops(B: int, S: int, H: int, P: int, N: int) -> float:
    """f32 operations of one ``_ssd_scan`` over (B, S): the intra-chunk
    scores (C B^T) and their decay weights (difference, mask, exp,
    product), the products with x dt, the chunk states' weighting and
    product with B, the inter-chunk recurrence, and the entering states'
    product with C and its decay."""
    L = min(SSD_CHUNK, S)
    nc = -(-S // L)
    bc = float(B * nc)
    return bc * (2.0 * L * L * N + 4.0 * L * L * H + 2.0 * H * L * L * P
                 + L * H * P + 2.0 * L * H * P * N + 2.0 * H * P * N
                 + 2.0 * L * N * H * P + L * H * P)


def _attn_flops(cfg, B: int, S: int) -> float:
    """q/k/v/o projections and causal attention (QK^T and PV over the kept
    pairs) of one attention block over B x S positions."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    T = B * S
    return (2.0 * T * d * (H + 2 * KV) * Dh + 2.0 * T * H * Dh * d
            + 4.0 * B * H * Dh * S * (S + 1) / 2)


def _flash_launches(cfg) -> int:
    """Flash launches of one prefill: one an attention layer (for audio one
    a decoder layer: the encoder's and the cross-attention are non-causal
    and stay chunked); none for ssm; one a shared-block application for
    hybrid."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return max(1, cfg.n_layers // (cfg.attn_every or cfg.n_layers))
    return cfg.n_layers


def _whisper_flops(cfg, B: int, S: int):
    """bf16 operations of a whisper prefill of B x S tokens over B x
    ``encoder_seq`` frames: (the encoder: the frame projection, q/k/v/o,
    non-causal attention over every pair, the SwiGLU MLP; the decoder:
    self q/k/v/o and causal attention over the kept pairs, cross q/o,
    cross k/v over the frames, cross-attention over S x T_enc pairs, the
    MLP), the head not included."""
    d, H, KV, Dh, T_e = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim(), cfg.encoder_seq
    Fe, Fd = B * T_e, B * S
    qkvo = lambda T: 2.0 * T * d * (H + 2 * KV) * Dh + 2.0 * T * H * Dh * d  # noqa: E731
    mlp = lambda T: 2.0 * T * 3 * d * cfg.d_ff  # noqa: E731
    enc = 2.0 * Fe * cfg.frontend_dim * d + cfg.encoder_layers * (
        qkvo(Fe) + 4.0 * B * H * Dh * T_e * T_e + mlp(Fe))
    dec = cfg.n_layers * (_attn_flops(cfg, B, S) + 2.0 * Fd * 2 * d * H * Dh
                          + 2.0 * Fe * d * 2 * KV * Dh + 4.0 * B * H * Dh * S * T_e + mlp(Fd))
    return enc, dec


def _whisper_encoder_bytes(cfg) -> int:
    """bf16 bytes of the encoder's params: the frame projection, the
    layers and the final norm."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    layer = 2 * d + d * (H + 2 * KV) * Dh + H * Dh * d + 3 * d * cfg.d_ff
    return 2 * (cfg.frontend_dim * d + cfg.encoder_layers * layer + d)


def family_bounds(cfg, B: int, S: int, param_bytes: int, cache_len: int) -> dict:
    """The least time of a prefill of B x S positions and of one decode
    step of B tokens. Bytes: every param but the embedding table (a gather
    reads B S of its rows), the hybrid's shared block once an application
    (an H100's 50 MB of L2 cannot hold its 236 MB), plus the KV cache a
    decode step reads and the SSM state it reads and writes. Prefill
    operations, as the reference computes them: the bf16 products (q/k/v/o
    projections, causal attention over the kept pairs, the dense MLP or
    the MoE's experts over their whole (E, C, d) capacity buffers (C =
    int(T K / E * 1.25)) and the router, arctic's dense residual MLP, the
    patch projector; ssm: the in/x/dt/out projections; hybrid: the Mamba-2
    in/out projections in every layer and the shared block's in_proj,
    attention and MLP once an application; the head at the last position)
    over the bf16 peak, plus the scans' f32 operations over the f32 peak;
    audio: ``_whisper_flops``, and apart the encoder's bound and the
    decoder's (its params' bytes or its operations, the head's included).
    The prefill bound is the larger of its bytes and operations times. An
    audio decode step reads the decoder's params (not the encoder's) and
    ``enc_out`` once a layer, and recomputes every layer's cross k/v from
    it (bf16 operations); its bound is the larger of the two times."""
    d, nl, T = cfg.d_model, cfg.n_layers, B * S
    embed_bytes = cfg.vocab_size * d * 2
    weight_bytes = param_bytes - embed_bytes
    f32_flops, state_bytes, kv_bytes, decode_flops, enc_bytes = 0.0, 0, 0, 0.0, 0
    if cfg.family == "audio":
        enc_flops, dec_flops = _whisper_flops(cfg, B, S)
        flops = enc_flops + dec_flops
        enc_bytes = _whisper_encoder_bytes(cfg)  # a decode step runs no encoder
        KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim()
        kv_bytes = nl * B * cache_len * KV * Dh * 2 * 2
        state_bytes = nl * B * cfg.encoder_seq * d * 2  # enc_out, read once a layer
        decode_flops = nl * 2.0 * B * cfg.encoder_seq * d * 2 * KV * Dh
    elif cfg.family == "ssm":
        di, N, R, K = cfg.resolved_d_inner(), cfg.ssm_state, cfg.resolved_dt_rank(), cfg.ssm_conv
        flops = nl * 2.0 * T * (d * 2 * di + di * (R + 2 * N) + R * di + di * d)
        f32_flops = nl * MAMBA1_SCAN_OPS * float(T) * di * N
        state_bytes = 2 * nl * B * (di * N * 4 + (K - 1) * di * 2)
    elif cfg.family == "hybrid":
        n_seg = _flash_launches(cfg)
        nm = n_seg * (cfg.attn_every or cfg.n_layers)
        di, H, N, K = cfg.resolved_d_inner(), cfg.resolved_ssm_heads(), cfg.ssm_state, \
            cfg.ssm_conv
        H_, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
        flops = nm * 2.0 * T * (d * (2 * di + 2 * N + H) + di * d)
        flops += n_seg * (_attn_flops(cfg, B, S) + 2.0 * T * 3 * d * cfg.d_ff
                          + 2.0 * T * 2 * d * d)
        f32_flops = nm * _ssd_f32_flops(B, S, H, di // H, N)
        shared_bytes = 2 * (2 * d * d + d * (H_ + 2 * KV) * Dh + H_ * Dh * d
                            + 3 * d * cfg.d_ff + 2 * d)
        weight_bytes += (n_seg - 1) * shared_bytes
        state_bytes = 2 * nm * B * (H * (di // H) * N * 4 + (K - 1) * (di + 2 * N) * 2)
        kv_bytes = n_seg * B * cache_len * KV * Dh * 2 * 2
    else:
        flops = _attn_flops(cfg, B, S)
        if cfg.family == "moe":
            E, K, F_ = cfg.n_experts, cfg.experts_per_token, cfg.moe_d_ff or cfg.d_ff
            C = max(1, int(T * K / E * 1.25))
            flops += 2.0 * E * C * 3 * d * F_ + 2.0 * T * d * E
            if cfg.dense_residual:
                flops += 2.0 * T * 3 * d * cfg.d_ff
        else:
            flops += 2.0 * T * 3 * d * cfg.d_ff
        flops = nl * flops
        kv_bytes = nl * B * cache_len * cfg.n_kv_heads * cfg.resolved_head_dim() * 2 * 2
    flops += 2.0 * B * d * cfg.vocab_size
    if cfg.frontend == "vision":
        flops += 2.0 * B * VLM_PATCHES * cfg.frontend_dim * d
    ops_ms = 1e3 * (flops / BF16_FLOPS + f32_flops / F32_FLOPS)
    bytes_ms = 1e3 * weight_bytes / HBM_BYTES_PER_S
    out = {"weight_bytes": weight_bytes, "prefill_bf16_flops": flops,
           "prefill_f32_flops": f32_flops,
           "prefill_bound_ms": max(bytes_ms, ops_ms),
           "prefill_bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "decode_bytes": weight_bytes - enc_bytes + kv_bytes + state_bytes}
    out["decode_bound_ms"] = bound_ms(out["decode_bytes"], decode_flops, BF16_FLOPS)
    if cfg.family == "audio":
        out.update(decode_bf16_flops=decode_flops,
                   decode_bound_by=bound_by(out["decode_bytes"], decode_flops, BF16_FLOPS),
                   encoder_bytes=enc_bytes, encoder_bf16_flops=enc_flops,
                   encoder_bound_ms=bound_ms(enc_bytes, enc_flops, BF16_FLOPS),
                   decoder_bf16_flops=flops - enc_flops,
                   decoder_bound_ms=bound_ms(weight_bytes - enc_bytes, flops - enc_flops,
                                             BF16_FLOPS))
    return out


class _PrefillRecorder:
    """Within ``with``: every flash call's (q, k, v, out) and every MoE
    routing's expert ids (T, K) and keep flags (T, K) of one prefill, layer
    by layer, by wrapping ``models.layers.flash_mha`` and ``_route_local``.
    The ids are recomputed from the router's own inputs with the same top-k
    (``_route_local`` returns them masked by keep)."""

    def __init__(self):
        self.attn, self.routes = [], []

    def __enter__(self):
        import torch

        from repro_torch.models import layers as L

        self._L, self._flash, self._route = L, L.flash_mha, L._route_local

        def flash(q, k, v, *, causal=True):
            out = self._flash(q, k, v, causal=causal)
            self.attn.append((q, k, v, out))
            return out

        def route(xf, router, E, K, capacity):
            got = self._route(xf, router, E, K, capacity)
            _, ids = L._top_k(torch.softmax(xf.to(torch.float32) @ router, dim=-1), K)
            self.routes.append((ids, got[3].reshape(-1, K)))
            return got

        L.flash_mha, L._route_local = flash, route
        return self

    def __exit__(self, *exc):
        self._L.flash_mha, self._L._route_local = self._flash, self._route
        return False


class _ScanRecorder:
    """Within ``with``: the first call of each scan function of
    ``models/ssm.py`` in a prefill (T > 1) and in a decode step (T = 1),
    its inputs and outputs cloned, by wrapping the module's
    ``_mamba1_chunked_scan``, ``_ssd_scan`` and ``_ssd_step`` (the
    blocks look them up at each call). The first calls are layer 0's."""

    NAMES = ("_mamba1_chunked_scan", "_ssd_scan", "_ssd_step")

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from repro_torch.models import ssm as S

        self._S, self._orig = S, {n: getattr(S, n) for n in self.NAMES}

        def wrap(name, fn):
            def recorded(*args):
                out = fn(*args)
                # _ssd_step's inputs have no time axis: it is decode's
                phase = "decode" if name == "_ssd_step" or args[0].shape[1] == 1 else "prefill"
                if (name, phase) not in self.calls:
                    self.calls[(name, phase)] = (tuple(a.clone() for a in args),
                                                 tuple(o.clone() for o in out))
                return out

            return recorded

        for n, fn in self._orig.items():
            setattr(S, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._S, n, fn)
        return False


# the reference's own tolerance for a chunked scan against its recurrence
# (tests/test_models.py)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)


def _families_scan_check(cfg, scans, prefill_ms: float, decode_ms: float) -> dict:
    """Layer 0's chunked scan, on the inputs a full-width prefill gave it,
    against the step-by-step recurrence (its plain version) within
    SCAN_TOL: y and the final state. Each scan timed on those inputs, and
    the decode step's scan (Mamba-1: the chunked scan at T = 1; SSD: its
    one-step recurrence) on the first decode step's; times the Mamba
    layers, their share of the prefill and of a decode step."""
    import torch

    from repro_torch.models import ssm as S

    if cfg.family == "ssm":
        name, step_name, plain = "_mamba1_chunked_scan", "_mamba1_chunked_scan", \
            S.mamba1_scan_plain
        n_mamba = cfg.n_layers
    else:
        name, step_name, plain = "_ssd_scan", "_ssd_step", S.ssd_scan_plain
        n_mamba = _flash_launches(cfg) * cfg.attn_every
    if (name, "prefill") not in scans.calls or (step_name, "decode") not in scans.calls:
        _fail(f"{cfg.name}: the scans were not recorded: {sorted(scans.calls)}")
    args, (y, h) = scans.calls[(name, "prefill")]
    yp, hp = plain(*args)
    torch.cuda.synchronize()
    out = {}
    for what, a, b in (("y", y, yp), ("h_final", h, hp)):
        err = (a - b).abs()
        out[f"{what}_max_abs_err"] = float(err.max())
        out[f"{what}_max_excess"] = float((err - SCAN_TOL["rtol"] * b.abs()).max())
        if not (torch.isfinite(a).all() and torch.allclose(a, b, **SCAN_TOL)):
            _fail(f"{cfg.name}: layer 0's chunked scan != its recurrence beyond "
                  f"{SCAN_TOL}: {what} max |d| {out[f'{what}_max_abs_err']}")
    fn = getattr(S, name)
    out["scan_ms"] = cuda_ms(lambda: fn(*args), reps=3, warmup=1)
    out["plain_ms"] = cuda_ms(lambda: plain(*args), reps=1, warmup=0)
    step_args = scans.calls[(step_name, "decode")][0]
    step = getattr(S, step_name)
    out["decode_scan_ms"] = cuda_ms(lambda: step(*step_args), reps=10)
    out["prefill_share"] = n_mamba * out["scan_ms"] / prefill_ms
    out["decode_share"] = n_mamba * out["decode_scan_ms"] / decode_ms
    shapes = [tuple(a.shape) for a in args]
    print(f"  layer 0's {name} on the prefill's inputs {shapes} against its recurrence: "
          f"y max |d| {out['y_max_abs_err']!r}, h_final max |d| {out['h_final_max_abs_err']!r} "
          f"(tolerance {SCAN_TOL}); scan {out['scan_ms']:.3f} ms, recurrence "
          f"{out['plain_ms']:.1f} ms; decode's {step_name} {out['decode_scan_ms']:.4f} ms; "
          f"x {n_mamba} layers: {out['prefill_share']:.3f} of the prefill, "
          f"{out['decode_share']:.3f} of a decode step")
    return {"scan": out}


def _family_line(cfg) -> str:
    """The config's widths for the phase's first line."""
    import torch

    from repro_torch.kernels import flash_attention as kfa

    if cfg.family == "ssm":
        return (f"Mamba-1 d_inner {cfg.resolved_d_inner()}, state {cfg.ssm_state}, dt rank "
                f"{cfg.resolved_dt_rank()}, conv {cfg.ssm_conv}, no attention")
    attn = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim()} (flash design "
            f"{kfa.kernel_design(torch.bfloat16, cfg.resolved_head_dim())})")
    if cfg.family == "audio":
        return (f"{cfg.encoder_layers} encoder layers over {cfg.encoder_seq} frames of "
                f"{cfg.frontend_dim}, {attn}, d_ff {cfg.d_ff}, sinusoidal positions")
    if cfg.family == "hybrid":
        H = cfg.resolved_ssm_heads()
        return (f"Mamba-2 d_inner {cfg.resolved_d_inner()}, {H} SSD heads of "
                f"{cfg.resolved_d_inner() // H}, state {cfg.ssm_state}; a shared block after "
                f"every {cfg.attn_every}: {attn}, d_ff {cfg.d_ff}")
    return (f"{attn}, experts {cfg.n_experts} top {cfg.experts_per_token} of {cfg.moe_d_ff}, "
            f"d_ff {cfg.d_ff}")


def _routing_diffs(a, b, B: int, S: int) -> dict:
    """Per layer, how many (token, slot) expert ids and keep flags differ
    between two prefills' routings, how many tokens route to a different
    set of experts or keep a different subset; and the batch rows whose
    last token routes and keeps alike in every layer."""
    import torch

    per_layer, last_same = [], torch.ones(B, dtype=torch.bool, device=a[0][0].device)
    for (ia, ka), (ib, kb) in zip(a, b):
        sa, oa = ia.sort(dim=-1)
        sb, ob = ib.sort(dim=-1)
        # keep flags aligned by expert id within each token
        kas, kbs = ka.gather(1, oa), kb.gather(1, ob)
        token_same = (sa == sb).all(-1) & (kas == kbs).all(-1)
        per_layer.append({"ids_differ": int((ia != ib).sum()),
                          "keep_differ": int((ka != kb).sum()),
                          "tokens_routed_differently": int((~token_same).sum()),
                          "pairs_dropped": [int((~ka).sum()), int((~kb).sum())]})
        last_same &= token_same.reshape(B, S)[:, -1]
    return {"layers": per_layer, "last_token_same": last_same.tolist()}


def phase_families(dev):
    """The moe, vlm, ssm, hybrid and audio families at full width through
    the serving entry points, one config at a time: kimi-k2-1t-a32b (1
    layer), arctic-480b (2 layers), qwen2-vl-2b, falcon-mamba-7b,
    zamba2-2.7b and whisper-tiny (full depth), bf16, random weights from a
    seed, the flash prefill. Per config: the param count and the init's
    peak; ``launch.serve.serve`` (4 x 2,048 tokens, 32 generated; for
    whisper 1,500 frames a request); flash against chunked prefill (not
    for ssm, which has no attention); for ssm and hybrid layer 0's scan
    against its recurrence; for audio the prefill's encoder and decoder
    timed apart; ``ServeEngine`` draining 8 requests; each reading beside
    its bound."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    launches_total, out = 0, {}
    for arch, n_layers, want_params, want_bytes in FAMILIES:
        cfg = get_arch(arch).with_(n_layers=n_layers, use_flash_kernel=True)
        model = build_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        params = model.init(gen, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated(dev) - base
        n_params = sum(t.numel() for t in tree_leaves(params))
        n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        print(f"families: {arch} {cfg.n_layers} of {get_arch(arch).n_layers} layers, d_model "
              f"{cfg.d_model}, {_family_line(cfg)}, vocab {cfg.vocab_size}: {n_params} params, "
              f"{n_bytes} B; init {init_s:.2f} s, peak {init_peak} B over the params' bytes by "
              f"{init_peak - n_bytes} B")
        if n_params != want_params or n_bytes != want_bytes:
            _fail(f"{arch} has {n_params} params / {n_bytes} B, want {want_params} / "
                  f"{want_bytes}")
        if init_peak > n_bytes + INIT_HEADROOM_BYTES:
            _fail(f"{arch}'s init peaked at {init_peak} B, over its {n_bytes} B of params "
                  f"+ {INIT_HEADROOM_BYTES}")
        if cfg.family == "moe" and params["layers"]["moe"]["router"].dtype != torch.float32:
            _fail("the MoE router is not f32")
        # (no local name for the param subtree: it would outlive the turn)
        if cfg.family in ("ssm", "hybrid") and any(
                params["layers" if cfg.family == "ssm" else "segments"]["mamba"][n].dtype
                != torch.float32 for n in ("A_log", "D", "dt_bias")):
            _fail(f"{arch}: A_log, D and dt_bias are not all f32")

        kw = dict(batch=B, prompt_len=P, seed=0, device=dev, params=params)
        # warm-up (cuBLAS handles, first launches): the same prompts and
        # params as the measured run, so for the ssm families it records
        # layer 0's scan inputs of that prefill and of the first decode step
        with _ScanRecorder() as scans:
            serve(cfg, gen=2, **kw)
        torch.cuda.reset_peak_memory_stats(dev)
        kfa.flash_mha.launches = 0
        res = serve(cfg, gen=G, **kw)
        launches = kfa.flash_mha.launches
        launches_total += launches
        toks = res.tokens.cpu().numpy()
        S = P + (VLM_PATCHES if cfg.family == "vlm" else 0)
        cache_len = res.cache["k"].shape[2] if "k" in res.cache else 0
        bounds = family_bounds(cfg, B, S, n_bytes, cache_len)
        rec = {"init_s": init_s, "init_peak_bytes": init_peak, "param_bytes": n_bytes,
               "prefill_ms": res.prefill_s * 1e3,
               "decode_ms_per_token": res.decode_s / (G - 1) * 1e3, "launches": launches}
        print(f"  serve B={B} S={S}: prefill {rec['prefill_ms']:.1f} ms (bound "
              f"{bounds['prefill_bound_ms']:.3f} ms, {bounds['prefill_bound_by']}), decode "
              f"{rec['decode_ms_per_token']:.2f} ms/token (bound {bounds['decode_bound_ms']:.3f} "
              f"ms: {bounds['decode_bytes']} B a step); flash launches {launches}; "
              f"bounds {json.dumps(bounds)}")
        print(f"  sample token ids: {toks[0, :16].tolist()} / {toks[1, :8].tolist()}")
        if launches != _flash_launches(cfg):
            _fail(f"{arch}: the flash prefill launched the kernel {launches} times, want "
                  f"{_flash_launches(cfg)}")
        if not res.all_finite or toks.shape != (B, G):
            _fail(f"{arch}: serve logits not finite or tokens misshapen")
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            _fail(f"{arch}: token ids out of the vocabulary")
        flash_logits = res.prefill_logits
        enc_out = res.cache.get("enc_out")
        del res

        if cfg.family in ("ssm", "hybrid"):
            rec.update(_families_scan_check(cfg, scans, rec["prefill_ms"],
                                            rec["decode_ms_per_token"]))
        del scans
        if cfg.family == "moe":
            rec.update(_families_moe_check(cfg, model, params, dev))
        elif cfg.family != "ssm":
            plain = serve(cfg.with_(use_flash_kernel=False), gen=1, **kw)
            if kfa.flash_mha.launches != launches:
                _fail("the chunked prefill launched the flash kernel")
            lf = torch.log_softmax(flash_logits, -1)
            lc = torch.log_softmax(plain.prefill_logits, -1)
            dmax = float((lf - lc).abs().max())
            top2 = plain.prefill_logits.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).tolist()
            agree = (flash_logits.argmax(-1) == plain.prefill_logits.argmax(-1)).tolist()
            print(f"  chunked prefill: {plain.prefill_s * 1e3:.1f} ms; flash vs chunked max "
                  f"|d log_softmax| {dmax!r} (tolerance {SERVE_LOGIT_TOL}), top-1 agree "
                  f"{agree}, chunked top-2 margins {[round(m, 4) for m in margin]}")
            if not dmax <= SERVE_LOGIT_TOL:
                _fail(f"{arch}: flash and chunked prefill disagree: {dmax} > {SERVE_LOGIT_TOL}")
            if any(not a and m > 2 * SERVE_LOGIT_TOL for a, m in zip(agree, margin)):
                _fail(f"{arch}: flash and chunked prefill pick different top-1 tokens away "
                      "from a near tie")
            rec.update(chunked_prefill_ms=plain.prefill_s * 1e3, max_dlogsoftmax=dmax)
            del plain
        if cfg.family == "audio":
            rec.update(_families_whisper_split(cfg, params, enc_out, bounds, rec, dev))
        del flash_logits, enc_out
        if L.flash_mha is not kfa.flash_mha:
            _fail("the prefill recorder was left installed")

        eng = ServeEngine(cfg, max_batch=4, cache_len=256, device=dev, params=params)
        calls, inner = [0], eng._decode

        def counted(p, c, b, inner=inner):
            calls[0] += 1
            return inner(p, c, b)

        eng._decode = counted
        rng = np.random.RandomState(1)
        reqs = [Request(i, rng.randint(0, cfg.vocab_size, size=rng.randint(16, 65)).astype(
                    np.int32), max_new_tokens=int(rng.randint(8, 25))) for i in range(8)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = eng.stats()
        eng_bound_s = calls[0] * family_bounds(cfg, 4, 1, n_bytes, 256)["decode_bound_ms"] / 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"  engine: 8 requests, max_batch 4, cache_len 256: {secs:.2f} s for {calls[0]} "
              f"decode calls (bound {eng_bound_s:.3f} s), stats {json.dumps(st)}; peak device "
              f"memory since the warm-up {peak} B")
        if len(done) != 8 or st["completed"] != 8:
            _fail(f"{arch}: the engine completed {len(done)} of 8 requests")
        if any(not (1 <= len(r.generated) <= r.max_new_tokens) for r in done):
            _fail(f"{arch}: a request generated a token count outside 1..max_new_tokens")
        if cfg.family == "audio" and eng.cache["enc_out"].any():
            _fail(f"{arch}: the engine wrote enc_out (the reference's decodes against zeros)")
        rec.update(engine_s=secs, engine_calls=calls[0], engine_bound_s=eng_bound_s,
                   peak_bytes=peak, bounds=bounds)
        out[arch] = rec
        del eng, params, model, kw
        torch.cuda.empty_cache()
        if torch.cuda.memory_allocated(dev) > base + 2**30:
            _fail(f"{arch}'s tensors outlived its turn: {torch.cuda.memory_allocated(dev)} B "
                  f"allocated, {base} B before")
    return dict(out, launches=launches_total)


def _families_whisper_split(cfg, params, enc_out, bounds, rec, dev) -> dict:
    """whisper's prefill in two parts, each timed apart (CUDA events, the
    median of 5 calls) beside its bound: ``whisper.encode`` on the serve
    flow's frames (``RandomState(0)``, drawn after the prompts) and the
    decoder (``decoder_forward`` with the flash self-attention, and the
    head at the last position) on its prompts against that encoder output.
    The encoder's output is held to the ``enc_out`` the serve flow's
    prefill cached, and is finite."""
    import numpy as np
    import torch

    from repro_torch.models import whisper as WH

    B, P = SERVE_BATCH, SERVE_PROMPT
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, P)), dtype=torch.int32, device=dev)
    frames = torch.as_tensor(rng.randn(B, cfg.encoder_seq, cfg.frontend_dim),
                             dtype=torch.float32, device=dev)
    with torch.no_grad():
        enc = WH.encode(params, frames, cfg)

        def decoder():
            x, _ = WH.decoder_forward(params, toks, enc, cfg, differentiable=False)
            return x[:, -1] @ params["lm_head"]

        out = {"encoder_ms": cuda_ms(lambda: WH.encode(params, frames, cfg), reps=5, warmup=1),
               "decoder_ms": cuda_ms(decoder, reps=5, warmup=1)}
    torch.cuda.synchronize()
    out["enc_out_max_abs_diff"] = float((enc.float() - enc_out.float()).abs().max())
    out["share_encoder"] = out["encoder_ms"] / rec["prefill_ms"]
    print(f"  prefill split: encoder {out['encoder_ms']:.3f} ms (bound "
          f"{bounds['encoder_bound_ms']:.4f} ms, {bounds['encoder_bf16_flops']:.4g} bf16 "
          f"operations over B {B} x {cfg.encoder_seq} frames), decoder + head "
          f"{out['decoder_ms']:.3f} ms (bound {bounds['decoder_bound_ms']:.4f} ms); the encoder "
          f"{out['share_encoder']:.3f} of the serve prefill; the encoder's output against "
          f"the cached enc_out max |d| {out['enc_out_max_abs_diff']!r}")
    if not bool(torch.isfinite(enc).all()) or enc.shape != (B, cfg.encoder_seq, cfg.d_model):
        _fail(f"{cfg.name}: the encoder's output is misshapen or not finite")
    if not torch.allclose(enc.float(), enc_out.float(), rtol=1e-2, atol=1e-2):
        _fail(f"{cfg.name}: the cached enc_out is not the encoder's output on the frames")
    return {"split": out}


def _families_moe_check(cfg, model, params, dev) -> dict:
    """Flash against chunked prefill for an MoE config. Routing is a
    discontinuous function of the attention output, and a bf16 rounding
    difference between the two prefills can flip a near-tied top-K choice,
    which can then, through capacity, drop a later token's pair. So: (a)
    each layer's flash output against ``chunked_attention`` on that
    prefill's own q, k, v, at the kernel's 128-key tile (the two then round
    p against the same running maxima) by ``flash_attention.mismatch``'s
    rule, and read at the config's ``attn_chunk``; (b) per layer, how many
    (token, slot) expert ids and keep flags differ between the flash and
    the chunked prefill; (c) the last-position log-softmax within
    SERVE_LOGIT_TOL on every batch row whose last token routes and keeps
    alike in every layer."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model

    B, P = SERVE_BATCH, SERVE_PROMPT
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32, device=dev)}
    chunked_model = build_model(cfg.with_(use_flash_kernel=False))
    with _PrefillRecorder() as fl:
        lf, _ = model.prefill(params, batch)
    with _PrefillRecorder() as ch:
        lc, _ = chunked_model.prefill(params, batch)
    torch.cuda.synchronize()
    if len(fl.attn) != cfg.n_layers or ch.attn or len(fl.routes) != cfg.n_layers \
            or len(ch.routes) != cfg.n_layers:
        _fail(f"recorded {len(fl.attn)} flash calls and {len(fl.routes)} / {len(ch.routes)} "
              f"routings for {cfg.n_layers} layers")
    attn = []
    for i, (q, k, v, o) in enumerate(fl.attn):
        tile = kfa.mismatch(o, L.chunked_attention(q, k, v, q_chunk=kfa.BK, k_chunk=kfa.BK))
        wide = kfa.mismatch(o, L.chunked_attention(q, k, v, q_chunk=cfg.attn_chunk,
                                                   k_chunk=cfg.attn_chunk))
        print(f"  layer {i} attention, flash vs chunked at the {kfa.BK}-key tile: "
              f"{json.dumps(tile)}; at attn_chunk {cfg.attn_chunk} (read only): "
              f"{json.dumps(wide)} {_flash_tol(torch.bfloat16)}")
        attn.append({"tile": tile, "attn_chunk": wide})
    del fl.attn
    diffs = _routing_diffs(fl.routes, ch.routes, B, P)
    for i, d in enumerate(diffs["layers"]):
        print(f"  layer {i} routing, flash vs chunked prefill over {B * P} tokens x "
              f"{cfg.experts_per_token}: {json.dumps(d)}")
    rows = [b for b, same in enumerate(diffs["last_token_same"]) if same]
    dl = (torch.log_softmax(lf, -1) - torch.log_softmax(lc, -1)).abs().amax(-1).tolist()
    print(f"  last-position max |d log_softmax| by row {dl} (tolerance {SERVE_LOGIT_TOL}); "
          f"rows held: {rows}; rows left out (the last token routes or keeps differently): "
          f"{[b for b in range(B) if b not in rows]}")
    for i, a in enumerate(attn):
        if not a["tile"]["within"]:
            _fail(f"layer {i}: flash attention != chunked beyond tolerance: {a['tile']}")
    if not rows:
        _fail("no batch row's last token routes alike in both prefills: nothing to hold")
    if any(dl[b] > SERVE_LOGIT_TOL for b in rows):
        _fail(f"flash and chunked prefill disagree on a row that routes alike: {dl}")
    return {"attention": attn, "routing": diffs, "max_dlogsoftmax_rows": dl, "rows_held": rows}


# ---------------------------------------------------------------- phase zoo

ZOO_ARCH, ZOO_LAYERS, ZOO_MESH = "kimi-k2-1t-a32b", 1, (2, 2)
ZOO_PLACE_ARCH = "stablelm-1.6b"  # the train phase's model
# the sharded MoE block against its plain version: the branch runs each
# model shard's 192 experts in its own batched products, the plain version
# all 384 in one, so cuBLAS may sum in another order; each expert's output
# is bf16, so the bound is 4 bf16 roundings (2^-8 each) of the plain
# output's largest magnitude
ZOO_MOE_ULPS = 4


class _MoeRecorder:
    """Within ``with``: the (params, x) of each ``models.layers.moe_block``
    call, by wrapping it (the transformer calls it through the module);
    with ``plain`` set, the block runs ``moe_sharded_plain`` on the mesh's
    (dp, mp) instead."""

    def __init__(self, plain=None):
        self.calls, self.plain = [], plain

    def __enter__(self):
        from repro_torch.models import layers as L

        self._L, self._block = L, L.moe_block

        def block(p, x, cfg, *, capacity_factor=1.25):
            self.calls.append((p, x))
            if self.plain is not None:
                return L.moe_sharded_plain(p, x, cfg, *self.plain,
                                           capacity_factor=capacity_factor)
            return self._block(p, x, cfg, capacity_factor=capacity_factor)

        L.moe_block = block
        return self

    def __exit__(self, *exc):
        self._L.moe_block = self._block
        return False


def _dropped_share(x, router, cfg, dp: int) -> float:
    """The share of (token, slot) pairs past their expert's capacity when
    x's tokens route in ``dp`` data shards, each at its own capacity."""
    import torch

    from repro_torch.models import layers as L

    E, K = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(-1, x.shape[-1])
    T_loc = xf.shape[0] // dp
    C = max(1, int(T_loc * K / E * 1.25))
    kept = sum(int(L._route_local(xf[i * T_loc:(i + 1) * T_loc], router, E, K, C)[3].sum())
               for i in range(dp))
    torch.cuda.synchronize()
    return 1.0 - kept / (xf.shape[0] * K)


def phase_zoo(dev):
    """The model zoo's mesh on the card. (1) kimi-k2-1t-a32b at full width
    (1 of 61 layers, the families phase's build, the flash prefill) prefills
    4 x 2,048 tokens under ``use_mesh`` of a (2, 2) ("data", "model") mesh
    of four shards on the card: the MoE takes the expert-parallel branch
    (span ``moe_shard_map``, 4,096 tokens a data shard), held against its
    plain version (``moe_sharded_plain``) within ZOO_MOE_ULPS and the
    prefill's logits against the same prefill through the plain version
    within SERVE_LOGIT_TOL; a decode step under the mesh (2 tokens a data
    shard x 8 < 384 experts) takes the local path and equals the unmeshed
    step bit for bit. (2) stablelm-1.6b's params and AdamW state placed on
    the mesh by ``tree_param_specs`` (``launch.sharding.place``), each
    device's bytes against the specs' reckoning and the allocator's, and
    gathered back bit for bit."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.util import tree_bytes, use_mesh

    t_phase = time.perf_counter()
    B, P = SERVE_BATCH, SERVE_PROMPT
    dp, mp = ZOO_MESH
    mesh = make_mesh(ZOO_MESH, ("data", "model"), devices=[dev] * (dp * mp))
    cfg = get_arch(ZOO_ARCH).with_(n_layers=ZOO_LAYERS, use_flash_kernel=True)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32, device=dev)}
    E, K = cfg.n_experts, cfg.experts_per_token
    T_loc = B * P // dp
    C_loc, C_one = max(1, int(T_loc * K / E * 1.25)), max(1, int(B * P * K / E * 1.25))
    print(f"zoo: {cfg.name} {cfg.n_layers} of {get_arch(ZOO_ARCH).n_layers} layers at full "
          f"width, {E} experts top {K}, B {B} x {P} tokens on a {dp} x {mp} (data, model) "
          f"mesh of {dev} x {dp * mp}: {T_loc} tokens a data shard, {E // mp} experts a model "
          f"shard, capacity {C_loc} a data shard ({C_one} unsharded)")

    def prefill():
        with use_mesh(mesh), torch.no_grad():
            return model.prefill(params, batch)

    with torch.no_grad():
        prefill()  # warm-up
        kfa.flash_mha.launches = 0
        with obs.enabled() as tracer, _MoeRecorder() as rec:
            logits, cache = prefill()
        torch.cuda.synchronize()
        spans = [e for e in tracer.events if e.name == "moe_shard_map"]
        launches = kfa.flash_mha.launches
        print(f"  prefill under the mesh: {len(spans)} moe_shard_map spans "
              f"{[e.args for e in spans]}; flash launches {launches}")
        if len(spans) != cfg.n_layers or any(
                (e.args["dp"], e.args["mp"], e.args["tokens"], e.args["capacity"], e.args["plain"])
                != (dp, mp, T_loc, C_loc, False) for e in spans):
            _fail(f"the MoE took the expert-parallel branch {len(spans)} times, want "
                  f"{cfg.n_layers} at dp {dp}, mp {mp}, {T_loc} tokens, capacity {C_loc}")
        if launches != _flash_launches(cfg):
            _fail(f"the zoo prefill launched flash {launches} times, want {_flash_launches(cfg)}")
        if not bool(torch.isfinite(logits).all()) or logits.shape != (B, cfg.vocab_size):
            _fail("the zoo prefill's logits are misshapen or not finite")
        p_moe, x_moe = rec.calls[0]
        del rec

        # (a) the MoE block: the branch against its plain version
        with use_mesh(mesh):
            out_s, aux_s = L.moe_block(p_moe, x_moe, cfg)
        out_p, aux_p = L.moe_sharded_plain(p_moe, x_moe, cfg, dp, mp)
        out_u, aux_u = L.moe_block(p_moe, x_moe, cfg)
        torch.cuda.synchronize()
        err = float((out_s.float() - out_p.float()).abs().max())
        scale = float(out_p.float().abs().max())
        tol = ZOO_MOE_ULPS * 2.0 ** -8 * scale
        differ = float((out_s != out_p).float().mean())
        unsharded_d = float((out_s.float() - out_u.float()).abs().max())
        drop_s = _dropped_share(x_moe, p_moe["router"], cfg, dp)
        drop_u = _dropped_share(x_moe, p_moe["router"], cfg, 1)
        print(f"  MoE block (layer 0's input, {tuple(x_moe.shape)} {x_moe.dtype}): branch vs "
              f"plain max |d| {err!r} (bound {tol!r}: {ZOO_MOE_ULPS} bf16 roundings of max "
              f"|out| {scale!r}), share of elements that differ {differ!r}, bit for bit "
              f"{err == 0.0}; aux {float(aux_s)!r} / {float(aux_p)!r}; against the unsharded "
              f"block (read only: other capacities) max |d| {unsharded_d!r}, aux "
              f"{float(aux_u)!r}; dropped pairs {drop_s!r} sharded ({dp} shards at C {C_loc}), "
              f"{drop_u!r} unsharded (C {C_one})")
        if not err <= tol or not bool(torch.isfinite(out_s).all()):
            _fail(f"the expert-parallel MoE differs from its plain version: {err} > {tol}")
        if float(aux_s) != float(aux_p):
            _fail(f"the branch's aux {float(aux_s)} != the plain version's {float(aux_p)}")

        def sharded_block():
            with use_mesh(mesh):
                return L.moe_block(p_moe, x_moe, cfg)

        ms_s = cuda_ms(sharded_block, reps=10, warmup=2)
        ms_p = cuda_ms(lambda: L.moe_sharded_plain(p_moe, x_moe, cfg, dp, mp), reps=10, warmup=2)
        ms_u = cuda_ms(lambda: L.moe_block(p_moe, x_moe, cfg), reps=10, warmup=2)
        del out_s, out_p, out_u

        # (b) the prefill's logits through the plain version
        with _MoeRecorder(plain=(dp, mp)):
            logits_p, _ = prefill()
        lsm = (torch.log_softmax(logits.float(), -1)
               - torch.log_softmax(logits_p.float(), -1)).abs().max()
        dl = float(lsm)
        print(f"  prefill through the plain MoE: max |d log_softmax| {dl!r} (tolerance "
              f"{SERVE_LOGIT_TOL}), bit for bit {bool(torch.equal(logits, logits_p))}")
        if not dl <= SERVE_LOGIT_TOL:
            _fail(f"the meshed prefill and the plain-MoE prefill disagree: {dl}")
        ms_prefill = cuda_ms(prefill, reps=5, warmup=1)
        ms_prefill_u = cuda_ms(lambda: model.prefill(params, batch), reps=5, warmup=1)

        # (c) a decode step under the mesh takes the local path
        cache = model.grow_cache(cache, P + 1)
        step = {"tokens": logits.argmax(-1).to(torch.int32)[:, None],
                "pos": torch.full((B,), P, dtype=torch.int32, device=dev)}
        want, _ = model.decode(params, {k: v.clone() for k, v in cache.items()}, step)
        with obs.enabled() as tracer, use_mesh(mesh):
            got, _ = model.decode(params, {k: v.clone() for k, v in cache.items()}, step)
        torch.cuda.synchronize()
        n_spans = len([e for e in tracer.events if e.name == "moe_shard_map"])
        same = bool(torch.equal(got, want))
        print(f"  decode step under the mesh ({B // dp} tokens a data shard x {K} < {E}): "
              f"moe_shard_map spans {n_spans}, equal to the unmeshed step bit for bit {same}")
        if n_spans or not same:
            _fail("the meshed decode step left the local path or differs from the unmeshed one")
    print(f"  ms: MoE block sharded {ms_s:.3f}, its plain version {ms_p:.3f}, unsharded "
          f"{ms_u:.3f}; prefill under the mesh {ms_prefill:.2f}, unmeshed {ms_prefill_u:.2f}")
    out = {"moe_max_abs_err": err, "moe_tol": tol, "moe_differ_share": differ,
           "dlogsoftmax": dl, "dropped_sharded": drop_s, "dropped_unsharded": drop_u,
           "moe_ms": ms_s, "moe_plain_ms": ms_p, "moe_unsharded_ms": ms_u,
           "prefill_ms": ms_prefill, "prefill_unmeshed_ms": ms_prefill_u,
           "flash_launches": launches}
    del params, model, logits, logits_p, cache, p_moe, x_moe, got, want
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated(dev) > base + 2**30:
        _fail(f"the zoo's kimi tensors outlived it: {torch.cuda.memory_allocated(dev)} B")

    # (d) placement at full width
    pcfg = get_arch(ZOO_PLACE_ARCH)
    pmodel = build_model(pcfg)
    gen.manual_seed(0)
    state = init_train_state(pmodel, adamw(1e-3), gen)
    tree = {"params": state["params"], "opt": state["opt"]}
    del state
    specs = {"params": shd.tree_param_specs(tree["params"], mesh, n_kv_heads=pcfg.n_kv_heads),
             "opt": {k: shd.tree_param_specs(v, mesh, n_kv_heads=pcfg.n_kv_heads)
                     for k, v in tree["opt"].items()}}
    want_dev = shd.tree_spec_nbytes(tree, specs, mesh)
    leaves = tree_leaves(tree)
    total = tree_bytes(tree)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    placed = shd.place(tree, shd.to_named(specs, mesh))
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    mem1 = torch.cuda.memory_allocated(dev)
    per_dev = shd.device_nbytes(placed)
    n_pieces = len(leaves) * dp * mp
    print(f"  placement: {pcfg.name} params + AdamW state, {len(leaves)} leaves, {total} B; "
          f"per device {per_dev.tolist()} B (the specs reckon {want_dev} B, {want_dev / total:.4f}"
          f" of the whole); the allocator grew {mem1 - mem0} B for {n_pieces} pieces; place "
          f"{place_s * 1e3:.1f} ms")
    if not (per_dev == want_dev).all():
        _fail(f"placed bytes {per_dev.tolist()} != the specs' {want_dev} a device")
    if not per_dev.sum() <= mem1 - mem0 <= per_dev.sum() + 512 * n_pieces:
        _fail(f"the allocator grew {mem1 - mem0} B for {per_dev.sum()} B of pieces")
    t0 = time.perf_counter()
    bad = 0
    for leaf, p_leaf in zip(leaves, tree_leaves(placed)):
        back = shd.gather(p_leaf)
        bad += not (back.dtype == leaf.dtype and back.shape == leaf.shape and torch.equal(
            back.reshape(-1).view(torch.uint8), leaf.reshape(-1).view(torch.uint8)))
        del back
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    print(f"  gathered back leaf by leaf in {gather_s * 1e3:.1f} ms: {len(leaves) - bad} of "
          f"{len(leaves)} leaves bit for bit")
    if bad:
        _fail(f"{bad} leaves did not gather back bit for bit")
    out.update(place_bytes_per_device=int(want_dev), place_total_bytes=total,
               place_ms=place_s * 1e3, gather_ms=gather_s * 1e3)
    del placed, tree, leaves
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  zoo phase {out['phase_s']:.1f} s: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 9

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_Q_STEPS = "stablelm-1.6b", 4, 2048, 6, 3
TRAIN_LR, TRAIN_WARMUP = 1e-3, 1
# |lm_loss - F.cross_entropy| / F.cross_entropy on one batch: the chunked
# loss takes the gold logit as an f32 dot with the head's column, the
# yardstick from the bf16-rounded logits; a token's gap is one bf16
# rounding of its gold logit, and the mean over 2,047 tokens averages it
CE_RTOL = 1e-4


def _kernel_wrappers():
    """Every kernel's launch-counting wrapper, by the JSON line's name."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk
    from repro_torch.kernels.ota_aggregate import ota_aggregate_2d
    from repro_torch.kernels.qmatmul import qmatmul as qmm
    from repro_torch.kernels.quantize import fake_quant_2d

    return {"ota_superpose": kota.ota_superpose, "ota_fold": kota.ota_fold,
            "topk_cosine": ktk.topk_cosine,
            "ota_quantize_superpose": kota.ota_quantize_superpose,
            "flash_attention": kfa.flash_mha, "fake_quant": fake_quant_2d, "qmatmul": qmm,
            "ota_aggregate": ota_aggregate_2d}


def train_bound_ms(cfg, B: int, S: int) -> dict:
    """The least time of one train step: the bf16 matrix products' 6 N T
    over the bf16 peak (N the blocks' and the head's matrix params, T the
    step's tokens), plus the chunked attention's f32 einsums (forward, its
    recompute under remat, and a backward of twice the forward) over the
    f32 peak. The two parts are summed: they run one after the other."""
    d, H, KV, Dh, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim(),
                        cfg.d_ff)
    n_block = d * (H + 2 * KV) * Dh + H * Dh * d + 3 * d * F_
    n_matmul = cfg.n_layers * n_block + d * cfg.vocab_size
    T = B * S
    bf16_flops = 6 * n_matmul * T
    c = min(cfg.attn_chunk, S)
    n = -(-S // c)
    pairs = n * (n + 1) // 2  # causal block skip: query chunk i visits key chunks 0..i
    fwd = pairs * 2 * (2 * B * H * c * c * Dh)  # QK^T and PV
    attn_flops = cfg.n_layers * fwd * (1 + (1 if cfg.remat else 0) + 2)
    return {"n_matmul": n_matmul, "tokens": T, "bf16_flops": bf16_flops,
            "attn_f32_flops": attn_flops, "bf16_ms": 1e3 * bf16_flops / BF16_FLOPS,
            "attn_ms": 1e3 * attn_flops / F32_FLOPS,
            "bound_ms": 1e3 * (bf16_flops / BF16_FLOPS + attn_flops / F32_FLOPS)}


def _step_ms(log) -> list:
    """Synchronised ms of each logged step, the batch's host draw excluded."""
    return [e["ms_per_step"] - e["batch_ms"] for e in log]


def _grads(model, params, batch):
    """(loss, gradient leaves in flatten order) of ``model.loss``."""
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.core.tree import tree_leaves

    loss, _, grads, _ = _value_and_grad(model, params, batch)
    return loss, tree_leaves(grads)


def _step_split(model, opt, state, batch) -> dict:
    """One train step's stages (``make_train_step``'s, in its order) between
    CUDA events: forward and backward, the clip, the optimizer, the update
    applied; and the host's enqueue time beside the synchronised total."""
    import torch

    from repro_torch.launch.steps import _apply, _value_and_grad
    from repro_torch.optim import clip_by_global_norm

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    _, _, grads, params = _value_and_grad(model, state["params"], batch)
    ev[1].record()
    grads, _ = clip_by_global_norm(grads, 1.0)
    ev[2].record()
    updates, opt_state = opt.update(grads, state["opt"], params, state["step"])
    ev[3].record()
    new_params = _apply(params, updates)
    ev[4].record()
    enqueue = (time.perf_counter() - t0) * 1e3
    ev[4].synchronize()
    total = (time.perf_counter() - t0) * 1e3
    del grads, params, updates, opt_state, new_params
    names = ("forward_backward_ms", "clip_ms", "optimizer_ms", "apply_ms")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    return dict(out, enqueue_ms=enqueue, synced_ms=total)


class _NoDonation:
    """Within ``with``: ``launch.train`` builds its step without donation
    (today's step before the donating one), for the run it is held to."""

    def __enter__(self):
        from repro_torch.launch import train

        self._train, self._real = train, train.make_train_step
        train.make_train_step = lambda model, opt, **kw: self._real(model, opt,
                                                                    **dict(kw, donate=False))
        return self

    def __exit__(self, *exc):
        self._train.make_train_step = self._real
        return False


def phase_train(dev):
    """stablelm-1.6b at full width and depth (bf16, remat) through the
    training entry point: 6 donating AdamW steps of 4 x 2,048 Markov tokens
    with f32 moments, their peak beside the same run's without donation
    (``_NoDonation``) and the states after the steps bit for bit; 3 with
    quantized moments from the same params and batches; the chunked loss
    against ``F.cross_entropy``; remat on and off at two layers; a reduced
    run checkpointed and resumed. No kernel launches."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_flatten, tree_leaves
    from repro_torch.data.lm import token_batches
    from repro_torch.launch import train
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import transformer as TF
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine, state_nbytes

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    cfg = get_arch(TRAIN_ARCH)
    bound = train_bound_ms(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads} of {cfg.resolved_head_dim()}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}, remat {cfg.remat}; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; "
          f"bound {json.dumps(bound)}")
    if not cfg.remat:
        _fail("stablelm-1.6b's config lost the reference's remat=True")

    # -- f32 moments, through the CLI's body (``main`` returns its log)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP),
            "--seed", "0", "--log-every", "1", "--device", str(dev)]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, log = train.run(train.parse_args(argv))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    f32_opt = state_nbytes(state["opt"])
    model = build_model(cfg)
    batch = {"tokens": torch.as_tensor(
        next(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0))["tokens"], device=dev)}
    split = _step_split(model, adamw(linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)),
                        state, batch)
    print(f"  one more step split (CUDA events, ms): {json.dumps(split)}")
    # -- the same run without donation, beside the donated state
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with _NoDonation():
        plain, plain_log = train.run(train.parse_args(argv))
    plain_peak = torch.cuda.max_memory_allocated(dev) - held
    unequal = [n for (n, a), (_, b) in zip(_leaf_names(state), _leaf_names(plain))
               if not _same_bits(a, b)]
    same_log = ([(e["loss"], e["grad_norm"]) for e in log]
                == [(e["loss"], e["grad_norm"]) for e in plain_log])
    print(f"  donated steps: peak device memory {peak} B over the {base} B allocated before the "
          f"run; without donation {plain_peak} B over the {held} B before it (the donated "
          f"state held); states after {TRAIN_STEPS} steps bit for bit {not unequal} (leaves "
          f"not: {unequal}); losses and grad norms bit for bit {same_log}")
    del state, plain
    torch.cuda.empty_cache()
    if unequal or not same_log:
        _fail(f"the donated train steps differ from the steps without donation: {unequal}")
    if not peak < plain_peak:
        _fail(f"the donated steps' peak {peak} B is not below the plain steps' {plain_peak} B")
    steps = _step_ms(log)
    for e, ms in zip(log, steps):
        print(f"  step {e['step']}: loss {e['loss']!r} grad_norm {e['grad_norm']!r} "
              f"step {ms:.2f} ms synchronised, {tokens / ms * 1e3:.0f} tokens/s, batch draw "
              f"{e['batch_ms']:.2f} ms (host)")
    steady = statistics.median(steps[1:])
    print(f"  f32 moments: {n_params} params, optimizer state {f32_opt} B; peak device memory "
          f"{peak} B; steady step (median of steps 2-{TRAIN_STEPS}) {steady:.2f} ms, "
          f"{tokens / steady * 1e3:.0f} tokens/s, bound share {bound['bound_ms'] / steady:.4f}; "
          f"run {run_s:.2f} s")
    if n_params != 1_644_267_520:
        _fail(f"stablelm-1.6b has {n_params} params, want 1,644,267,520")
    losses = [e["loss"] for e in log]
    if not all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) for e in log):
        _fail(f"non-finite loss or grad norm: {log}")
    if abs(losses[0] - np.log(cfg.vocab_size)) > 1.5:
        _fail(f"first loss {losses[0]} is not within 1.5 of ln V = {np.log(cfg.vocab_size)}")
    if not losses[-1] < losses[0]:
        _fail(f"the loss did not fall: {losses}")

    # -- quantized moments: the same params (the generator's seed) and batches
    opt = adamw(linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS), quantize=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    qstate = init_train_state(model, opt, gen)
    q_opt = state_nbytes(qstate["opt"])
    step_fn = make_train_step(model, opt)
    data = token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    qlog = []
    for _ in range(TRAIN_Q_STEPS):
        batch = {"tokens": torch.as_tensor(next(data)["tokens"], device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qstate, metrics = step_fn(qstate, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        qlog.append((loss, gnorm, (time.perf_counter() - t0) * 1e3))
    ratio = q_opt / f32_opt
    print(f"  quantized moments: optimizer state {q_opt} B = {ratio:.4f} x the f32 moments'; "
          f"steps (loss, grad_norm, ms): {qlog!r}")
    if not ratio <= 0.5:
        _fail(f"quantized optimizer state is {ratio} x the f32 state's, want <= 0.5")
    if not all(np.isfinite(lq) and np.isfinite(g) for lq, g, _ in qlog):
        _fail("non-finite loss with quantized moments")
    if qlog[0][0] != losses[0]:
        _fail(f"first loss {qlog[0][0]!r} differs from the f32 run's {losses[0]!r}")
    params = qstate["params"]
    del qstate, metrics
    torch.cuda.empty_cache()

    # -- the chunked loss against the library's cross-entropy
    toks = torch.as_tensor(next(token_batches(cfg.vocab_size, 1, TRAIN_SEQ, seed=7))["tokens"],
                           device=dev)
    with torch.no_grad():
        ce, _ = TF.lm_loss(params, {"tokens": toks}, cfg)
        x, head, _ = TF.lm_logits_and_aux(params, {"tokens": toks}, cfg)
        logits = (x[:, :-1] @ head).to(torch.float32)
        lib = F.cross_entropy(logits.reshape(-1, cfg.vocab_size), toks[:, 1:].reshape(-1).long())
    ce, lib = float(ce), float(lib)
    rel = abs(ce - lib) / abs(lib)
    print(f"  chunked lm_loss {ce!r} vs F.cross_entropy {lib!r} on 1 x {TRAIN_SEQ}: relative "
          f"{rel!r} (tolerance {CE_RTOL})")
    if not rel <= CE_RTOL:
        _fail(f"lm_loss and F.cross_entropy disagree: {rel} > {CE_RTOL}")
    del params, x, head, logits

    # -- remat on and off at two layers of the full width
    cfg2 = cfg.with_(n_layers=2)
    gen.manual_seed(1)
    p2 = build_model(cfg2).init(gen, dev)
    batch = {"tokens": torch.as_tensor(
        next(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0))["tokens"], device=dev)}
    l_off, g_off = _grads(build_model(cfg2.with_(remat=False)), p2, batch)
    l_on, g_on = _grads(build_model(cfg2.with_(remat=True)), p2, batch)
    names = [n for n, _ in _leaf_names(p2)]
    diffs = {n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(names, g_off, g_on)}
    print(f"  remat on vs off at 2 layers: loss {float(l_on)!r} / {float(l_off)!r}; max |d grad| "
          f"per leaf {json.dumps(diffs)}")
    if not torch.equal(l_on, l_off):
        _fail("remat changed the loss")
    # the embedding's and the head's gradients gather rows and columns, whose
    # backward accumulates into bf16 rows by index; every other leaf must be
    # bit for bit
    for n, a, b in zip(names, g_off, g_on):
        scale = float(a.float().abs().max())
        if n in ("embed", "lm_head"):
            if diffs[n] > 2**-6 * scale:
                _fail(f"remat moved {n}'s gradient by {diffs[n]} (max |g| {scale})")
        elif diffs[n] != 0.0:
            _fail(f"remat changed {n}'s gradient: max |diff| {diffs[n]}")
    del p2, g_off, g_on

    # -- a reduced run checkpointed every 2 steps, then resumed
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        rargv = ["--arch", TRAIN_ARCH, "--reduced", "--batch", "2", "--seq", "64",
                 "--log-every", "1", "--ckpt-dir", ck, "--ckpt-every", "2", "--device", str(dev)]
        saved, log4 = train.run(train.parse_args(rargv + ["--steps", "4"]))
        restored, meta = load_checkpoint(f"{ck}/ckpt_00000004.msgpack.zst", dev)
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(tree_flatten(saved)[0], tree_flatten(restored)[0]))
        log6 = train.main(rargv + ["--steps", "6"])
    print(f"  resume: steps {[e['step'] for e in log4]} then {[e['step'] for e in log6]}; the "
          f"step-4 file restores the saved state bit for bit: {same} (meta step {meta['step']})")
    if not same or meta["step"] != 4:
        _fail("the checkpoint does not restore the saved train state")
    if [e["step"] for e in log6] != [5, 6]:
        _fail(f"the resumed run did not continue from step 4: {log6}")

    launches = {n: fn.launches for n, fn in wrappers.items()}
    print(f"  kernel launches during training: {launches}")
    if any(launches.values()):
        _fail(f"training launched a kernel: {launches}")
    torch.cuda.empty_cache()
    return dict(steady_ms=steady, peak_bytes=peak, plain_peak_bytes=plain_peak, bound=bound,
                split=split, quantized_ratio=ratio, ce_rel=rel, remat_diffs=diffs)


# ---------------------------------------------------------------- phase shardtrain

SHARD_MESH = (2, 2)
# the sharded step against the unsharded one, bf16 at full width: each data
# shard's bf16 gradient is rounded before the f32 sum, the unsharded
# step's once for the whole batch, and Adam's update turns the moments'
# last bits into bf16 roundings of the params. Each bound sits between the
# honest run's reading and the planted fault's (data shard 1's gradient
# dropped), in brackets (an NVIDIA H100 80GB HBM3 at 700 W; repeated runs
# read the same bits):
SHARD_LOSS_RTOL = 1e-4  # each step's loss [3.0e-6; 5.8e-4 at step 3]
SHARD_GNORM_RTOL = 1e-2  # each step's grad norm [8.1e-4; 0.29-0.34]
SHARD_MOMENT_RTOL = 0.1  # moments, worst leaf max |d| / max |b| [4.2e-2; 1.15]
SHARD_PARAM_SHARE = 0.4  # bf16 params that differ after 3 steps [0.181; 0.841]
# the largest param difference after 3 steps [3.4e-3; 4.0e-3]: a few
# elements take a sign-flipped lr step either way, so it does not tell the
# fault apart; held to two such steps at lr 1e-3 with a bf16 rounding
SHARD_PARAM_MAX = 8e-3
# the tensor-parallel route (``tensor_parallel=True``) on these meshes of
# four shards of the card, 3 steps each from the same state
TP_MESHES = ((2, 2), (1, 4))
# its bounds against the unsharded steps, each between the honest runs'
# readings on both meshes and the planted fault's on (2, 2) (model shard
# 1's partial dropped from every row-parallel sum, ``models.layers._row_sum``),
# in brackets (an NVIDIA H100 80GB HBM3 at 700 W). The fault moves step 1
# less than a dropped data shard does: with random weights the residual
# stream carries most of each layer's output.
TP_LOSS_RTOL = 1e-4  # each step's loss [2.7e-5; 6.2e-4-1.9e-3]
TP_GNORM_RTOL = 4e-3  # each step's grad norm [1.1e-3; 7.9e-3 at step 1, 5.7e-2-9.7e-2]
TP_MOMENT_RTOL = 0.3  # moments, worst leaf max |d| / max |b| [6.7e-2; 1.98]
TP_PARAM_SHARE = 0.6  # bf16 params that differ after 3 steps [0.325; 0.870]
# stages of the sharded step (``launch.steps``' functions) timed by CUDA events
SHARD_STAGES = (("_placed", "placement"), ("_shard_live", "gathers"),
                ("_forward_backward", "forward_backward"), ("_accumulate", "grad_mean"),
                ("_cast", "grad_mean"), ("_clip", "clip"), ("_update", "optimizer"))


class _GcClock:
    """Within ``with``: the host's garbage collections, their ms and the
    full ones (generation 2), through ``gc.callbacks``; ``read()`` gives
    the totals so far."""

    def __enter__(self):
        import gc

        self.ms, self.full, self._t0 = 0.0, 0, 0.0

        def cb(phase, info):
            if phase == "start":
                self._t0 = time.perf_counter()
                return
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2

        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)
        return False

    def read(self) -> tuple:
        return self.ms, self.full


class _StepSplit:
    """Within ``with``: a pair of CUDA events around each call of the
    sharded step's stages (``SHARD_STAGES``, by wrapping ``launch.steps``'
    module functions; a recursive call is timed once, at its outermost),
    and the caching allocator's books around it: the bytes allocated at
    its entry and exit, the most allocated within it (the allocator's peak
    is reset at each stage, and ``peak`` keeps the most over all), the
    cudaMalloc calls it made and its retries (a cudaMalloc that failed,
    freed the cache and tried again), and the host's garbage collections
    within it (ms, and how many were full ones: a host stall the device
    sees as idle once its queue drains). The tensor-parallel route's
    row-parallel sums (``models.layers._row_sum``, inside the forward and
    remat's recompute) are timed apart, by events alone, as the stage
    "reductions" (within forward_backward). ``take()`` sums each stage's
    ms per step, lists each forward+backward (ms and books) and each
    stage's books."""

    def __init__(self, dev):
        self.dev, self.events, self.peak, self.reductions = dev, [], 0, []

    def _books(self) -> tuple:
        import torch

        s = torch.cuda.memory_stats(self.dev)
        return (torch.cuda.memory_allocated(self.dev),
                s.get("num_device_alloc", s.get("segment.all.allocated", 0)),
                s.get("num_alloc_retries", 0)) + self._gc.read()

    def __enter__(self):
        import torch

        from repro_torch.launch import steps

        self._gc = _GcClock().__enter__()
        self._steps, self._real = steps, {}
        for fn, stage in SHARD_STAGES:
            real = self._real[fn] = getattr(steps, fn)
            depth = [0]

            def wrap(*a, _real=real, _stage=stage, _depth=depth, **kw):
                if _depth[0]:
                    return _real(*a, **kw)
                entry, mallocs, retries, gc_ms, gc_full = self._books()
                self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev))
                torch.cuda.reset_peak_memory_stats(self.dev)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                _depth[0] += 1
                try:
                    return _real(*a, **kw)
                finally:
                    _depth[0] -= 1
                    ev[1].record()
                    top = torch.cuda.max_memory_allocated(self.dev)
                    self.peak = max(self.peak, top)
                    out, m1, r1, g1, f1 = self._books()
                    self.events.append((_stage, ev, {
                        "entry": entry, "peak": top, "exit": out, "mallocs": m1 - mallocs,
                        "retries": r1 - retries, "gc_ms": g1 - gc_ms, "gc_full": f1 - gc_full}))

            setattr(steps, fn, wrap)

        from repro_torch.models import layers

        self._layers, self._row_sum = layers, layers._row_sum

        def row_sum(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            try:
                return self._row_sum(*a, **kw)
            finally:
                ev[1].record()
                self.reductions.append(ev)

        layers._row_sum = row_sum
        return self

    def __exit__(self, *exc):
        for fn, real in self._real.items():
            setattr(self._steps, fn, real)
        self._layers._row_sum = self._row_sum
        self._gc.__exit__()
        return False

    def take(self) -> dict:
        """The stages' ms and books since the last ``take`` (synchronises)."""
        import torch

        torch.cuda.synchronize()
        out = {stage: 0.0 for _, stage in SHARD_STAGES}
        shards, books = [], {}
        for stage, (a, b), m in self.events:
            ms = a.elapsed_time(b)
            out[stage] += ms
            if stage == "forward_backward":
                shards.append(dict(m, ms=ms))
            rec = books.setdefault(stage, dict(m, peak=0, mallocs=0, retries=0, gc_ms=0.0,
                                               gc_full=0))
            rec["exit"] = m["exit"]
            rec["peak"] = max(rec["peak"], m["peak"])
            for k in ("mallocs", "retries", "gc_ms", "gc_full"):
                rec[k] += m[k]
        self.events = []
        out["reductions"] = sum(a.elapsed_time(b) for a, b in self.reductions)
        out["reduction_calls"], self.reductions = len(self.reductions), []
        return dict(out, forward_backward_per_shard=shards, books=books)


class _DropShard:
    """Planted fault: within ``with``, data shard ``k``'s gradients are
    zeros (``launch.steps._forward_backward``'s k-th call of each step)."""

    def __init__(self, n_shards: int, k: int = 1):
        self.n, self.k, self.calls = n_shards, k, 0

    def __enter__(self):
        import torch

        from repro_torch.launch import steps

        self._steps, self._real = steps, steps._forward_backward

        def fb(*a, **kw):
            loss, metrics, grads = self._real(*a, **kw)
            self.calls += 1
            if (self.calls - 1) % self.n == self.k:
                grads = [(i, box, torch.zeros_like(g)) for i, box, g in grads]
            return loss, metrics, grads

        steps._forward_backward = fb
        return self

    def __exit__(self, *exc):
        self._steps._forward_backward = self._real
        return False


class _DropPartial:
    """Planted fault: within ``with``, model shard ``k``'s partial left out
    of every row-parallel sum (``models.layers._row_sum``), or with
    ``callers`` of those that the functions of those names make."""

    def __init__(self, k: int = 1, callers=None):
        self.k, self.calls, self.callers = k, 0, callers

    def __enter__(self):
        from repro_torch.models import layers

        self._layers, self._real = layers, layers._row_sum

        def row_sum(partials, home, dtype):
            if self.callers is not None and sys._getframe(1).f_code.co_name not in self.callers:
                return self._real(partials, home, dtype)
            self.calls += 1
            return self._real([t for m, t in enumerate(partials) if m != self.k], home, dtype)

        layers._row_sum = row_sum
        return self

    def __exit__(self, *exc):
        self._layers._row_sum = self._real
        return False


def _to_host(tree):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t.to("cpu"), tree)


def _state_readings(placed, want, dev) -> tuple:
    """A placed train state against a plain one (on the host or the card),
    group by group (params, each optimizer entry): the share of elements
    that differ, the largest difference and the worst leaf's max |d| /
    max |b|; and the leaves that are not bit for bit equal."""
    import torch

    from repro_torch.launch import sharding as shd

    out, unequal = {}, []
    groups = [("params", placed["params"], want["params"])]
    groups += [(k, placed["opt"][k], want["opt"][k]) for k in sorted(want["opt"])]
    for g, ptree, wtree in groups:
        differ = total = 0
        max_abs = worst = 0.0
        for (name, pl), (_, wl) in zip(_leaf_names(ptree), _leaf_names(wtree)):
            a, b = shd.gather(pl, dev), wl.to(dev)
            if not (a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                       b.reshape(-1).view(torch.uint8))):
                unequal.append(f"{g}.{name}")
            d = (a.to(torch.float32) - b.to(torch.float32)).abs()
            differ += int((d > 0).sum())
            total += d.numel()
            top = float(d.max())
            max_abs = max(max_abs, top)
            worst = max(worst, top / max(float(b.to(torch.float32).abs().max()), 1e-30))
            del a, b, d
        out[g] = {"differ_share": differ / total, "max_abs": max_abs, "max_rel": worst}
    return out, unequal


def _metric_rel(got: dict, want) -> dict:
    return {k: abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30)
            for k in ("loss", "grad_norm")}


def _distinct_piece_bytes(shapes, specs, mesh, itemsize: int = 4) -> int:
    """Bytes of one ``itemsize`` copy of each distinct piece of a tree
    placed by ``specs`` (the step's f32 gradient sums)."""
    import numpy as np

    from repro_torch.launch import sharding as shd

    if isinstance(specs, shd.P):
        shape = tuple(shapes.shape)
        distinct = {shd._piece_bounds(shape, shd.NamedSharding(mesh, specs), idx)
                    for idx in np.ndindex(mesh.devices.shape)}
        n = 1
        for dim in shd.piece_shape(shape, specs, mesh):
            n *= dim
        return len(distinct) * n * itemsize
    return sum(_distinct_piece_bytes(shapes[k], specs[k], mesh, itemsize) for k in shapes)


def _read_copy_bytes(shapes, specs, mesh, cfg, tp: bool, path=()) -> int:
    """Bytes data shard 0's read of the params copies on one card: each
    leaf read whole, or on the tensor-parallel route each block
    (``launch.steps._tp_axis``), whose box is not one piece of its
    placement (a piece that covers it exactly is read as it is)."""
    import numpy as np

    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps

    if isinstance(shapes, dict):
        return sum(_read_copy_bytes(shapes[k], specs[k], mesh, cfg, tp, path + (k,))
                   for k in shapes)
    shape = tuple(shapes.shape)
    mp = mesh.shape["model"]
    full = tuple((0, d) for d in shape)
    boxes = [full]
    axis = steps._tp_axis(path, shape, specs, cfg if tp else None, mp)
    if axis is not None:
        ax, n = len(shape) + axis, shape[len(shape) + axis] // mp
        boxes = [full[:ax] + ((m * n, (m + 1) * n),) + full[ax + 1:] for m in range(mp)]
    pieces = {shd._piece_bounds(shape, shd.NamedSharding(mesh, specs), idx)
              for idx in np.ndindex(mesh.devices.shape)}
    return sum(int(np.prod([b - a for a, b in box])) * shapes.element_size()
               for box in boxes if box not in pieces)


# f32 temporaries alive at once in one box of the donating update (AdamW's
# ``Optimizer.leaf`` with weight decay: the f32 gradient, m, v, m-hat, the
# denominator, the update twice, the f32 param and its decay term), and the
# param's f32 sum beside them
BOX_F32_TEMPS = 10


def box_temp_bytes(shapes, specs, mesh, blockwise: bool = False) -> int:
    """One box's f32 temporaries in the donating update, for the largest
    box (``launch.steps._row_boxes``) of any piece of a tree placed by
    ``specs``."""
    import math

    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps

    if not isinstance(specs, shd.P):
        return max(box_temp_bytes(shapes[k], specs[k], mesh, blockwise) for k in shapes)
    shape = shd.piece_shape(tuple(shapes.shape), specs, mesh)
    row = math.prod(shape[1:])
    return max((b[0][1] - b[0][0]) * row if b else 1
               for b in steps._row_boxes(shape, blockwise)) * 4 * BOX_F32_TEMPS


def shard_reckoning(placed_dev: int, n_dev: int, param_bytes: int, sums_bytes: int,
                    act_bytes: int, gathered: int, box_bytes: int) -> dict:
    """The donating sharded step's peak device bytes on one card, reckoned
    before the run: the placed state on every mesh device, one data
    shard's copied params (``gathered``, ``_read_copy_bytes``) and its bf16
    gradients, the f32 sums of the distinct pieces, remat's activations;
    and the update in place: the placed state, the clipped bf16 gradients
    and one box's temporaries (``box_temp_bytes``). The peak is the larger
    of the backward's and the update's."""
    placed = placed_dev * n_dev
    backward = placed + gathered + param_bytes + sums_bytes + act_bytes
    update = placed + param_bytes + box_bytes
    return {"placed": placed, "gathered": gathered, "grads_bf16": param_bytes,
            "f32_sums": sums_bytes, "activations": act_bytes, "box_temps": box_bytes,
            "backward_peak": backward, "update_peak": update, "peak": max(backward, update)}


def _remat_act_bytes(cfg, B: int, S: int) -> int:
    """Remat's activations of one data shard: each layer's saved input, one
    layer recomputed (its MLP's three (B, S, d_ff) bf16 tensors, the
    chunked attention's f32 scores of one query chunk against the keys)
    and the loss's f32 logits of one chunk with their gradient."""
    d, F_, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    c = min(cfg.attn_chunk, S)
    saved = cfg.n_layers * B * S * d * 2
    layer = 3 * B * S * F_ * 2 + 2 * B * H * c * S * 4 + 6 * B * S * d * 2
    loss = 3 * B * min(cfg.loss_chunk, S) * cfg.vocab_size * 4
    return saved + layer + loss


def _outside(rels, r, tols) -> list:
    """The bounds (loss, grad norm, param share, moments) that a sharded
    run's per-step metrics and final state break."""
    loss_tol, gnorm_tol, share_tol, moment_tol = tols
    out = [f"{k} step {i + 1}" for i, rel in enumerate(rels) for k, tol in
           (("loss", loss_tol), ("grad_norm", gnorm_tol)) if rel[k] > tol]
    out += ["param share"] * (r["params"]["differ_share"] > share_tol)
    return out + [k for k in ("m", "v") if r[k]["max_rel"] > moment_tol]


def phase_shardtrain(dev):
    """The sharded train step (``launch.steps.make_sharded_train_step``) on
    the card: stablelm-1.6b at full width and depth (the train phase's
    build, seed, optimizer and batches). Every sharded step donates its
    state (``donate=True``: each piece written in place). (1) 3 unsharded
    steps (the plain results kept on the host), then 3 sharded steps from
    the same state on a (2, 2) ("data", "model") mesh of four shards of the
    card, each step's loss and grad norm and, after step 3, the params and
    moments held to the unsharded ones; each device's bytes the specs'
    after every step; step ms both ways, the sharded step split by CUDA
    events, the peak beside its reckoning (``shard_reckoning``, which it
    must not pass), the update's peak at or under the forward and
    backward's; the same 3 steps without donation first, whose pieces the
    donated ones must equal bit for bit, and whose peak is printed beside.
    (2) The same 3 steps with data shard 1's gradient
    dropped (a planted fault) must fail those bounds. (3) Step 2 on a (1,
    1) mesh, bit for bit the unsharded step 2 on every leaf but the
    embedding's and the head's (and their moments). (4) One step with
    quantized moments on the (2, 2) mesh against the unsharded one. (5)
    The tensor-parallel route (``tensor_parallel=True``: the attention,
    MLP, embedding and head split over ``model``) on each ``TP_MESHES``
    mesh ((2, 2) and (1, 4) of four shards of the card): 3 steps from the
    same state held to the same unsharded steps by the ``TP_*`` bounds,
    the bytes a device the specs', step ms, the split (the row-parallel
    sums as their own stage, "reductions"), the peak beside its
    reckoning (on (2, 2) also without donation, bit for bit, as in (1));
    and 3 steps on (2, 2) with model shard 1's partial dropped
    from every row-parallel sum (a planted fault), which must fail those
    bounds. (6) One step on a (2, 1) mesh both ways: with no model axis
    there are no blocks, so the two routes are bit for bit the same. (7)
    The ssm, hybrid and audio families on the tensor-parallel route
    (``_shardtrain_tp_families``). No kernel launches."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.lm import token_batches
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.util import tree_bytes, use_mesh

    t_phase = time.perf_counter()
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    dp, mp = SHARD_MESH
    mesh = make_mesh(SHARD_MESH, ("data", "model"), devices=[dev] * (dp * mp))
    one = make_mesh((1, 1), ("data", "model"), devices=[dev])
    sched = linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    opt, opt_q = adamw(sched), adamw(sched, quantize=True)
    data = token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [torch.as_tensor(next(data)["tokens"]) for _ in range(3)]
    gen = torch.Generator(device=dev)

    def fresh(o):
        gen.manual_seed(0)
        return steps.init_train_state(model, o, gen)

    def shardings(o, m):
        shapes = steps.train_state_shapes(model, o)
        specs = {"params": shd.tree_param_specs(shapes["params"], m, n_kv_heads=cfg.n_kv_heads),
                 "opt": {k: shd.tree_param_specs(v, m, n_kv_heads=cfg.n_kv_heads)
                         for k, v in shapes["opt"].items()}, "step": shd.P()}
        b = shd.batch_spec({"tokens": batches[0]}, m)
        return shapes, specs, shd.to_named(specs, m), shd.to_named(b, m)

    def setup(m, tp: bool) -> dict:
        """A mesh's shardings, its bytes a device and its peak reckoning."""
        m_shapes, m_specs, m_sh, mb_sh = shardings(opt, m)
        n_dev, m_dp = m.devices.size, m.shape["data"]
        want = shd.tree_spec_nbytes(m_shapes, m_specs, m)
        reck = shard_reckoning(
            want, n_dev, tree_bytes(m_shapes["params"]),
            _distinct_piece_bytes(m_shapes["params"], m_specs["params"], m),
            _remat_act_bytes(cfg, TRAIN_BATCH // m_dp, TRAIN_SEQ),
            _read_copy_bytes(m_shapes["params"], m_specs["params"], m, cfg, tp),
            box_temp_bytes(m_shapes["params"], m_specs["params"], m))
        return {"mesh": m, "shapes": m_shapes, "s_sh": m_sh, "b_sh": mb_sh, "want_dev": want,
                "n_dev": n_dev, "dp": m_dp, "tp": tp, "reck": reck}

    meshes = {("gather", SHARD_MESH): setup(mesh, False)}
    for dims in TP_MESHES:
        meshes[("tp", dims)] = setup(make_mesh(dims, ("data", "model"), devices=[dev] * 4), True)
    shapes, s_sh, b_sh = (meshes[("gather", SHARD_MESH)][k] for k in ("shapes", "s_sh", "b_sh"))
    want_dev, reck = meshes[("gather", SHARD_MESH)]["want_dev"], meshes[("gather", SHARD_MESH)]["reck"]
    B_loc = TRAIN_BATCH // dp
    print(f"shardtrain: {cfg.name} {cfg.n_layers} layers at full width, {cfg.param_dtype}, remat "
          f"{cfg.remat}; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, {B_loc} x {TRAIN_SEQ} a data "
          f"shard on a {dp} x {mp} (data, model) mesh of {dev} x {dp * mp}; placed state "
          f"{want_dev} B a device; peak reckoning (B) {json.dumps(reck)}")
    for (route, dims), st in meshes.items():
        if route == "tp":
            print(f"  tensor-parallel route on {dims}: placed state {st['want_dev']} B a device; "
                  f"peak reckoning (B) {json.dumps(st['reck'])}")

    # (1a) the unsharded steps; their states after steps 1-3 kept on the host
    torch.cuda.empty_cache()
    state = fresh(opt)
    ref = steps.make_train_step(model, opt)
    u_log, host = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_mesh(mesh):
            state, met = ref(state, {"tokens": b.to(dev)})
        met = {k: float(v) for k, v in met.items()}
        u_log.append(dict(met, ms=(time.perf_counter() - t0) * 1e3))
        host.append(_to_host(state))
    del state, met
    torch.cuda.empty_cache()
    print(f"  unsharded steps: {json.dumps(u_log)}")

    def sharded_run(key, fault: bool = False, donate: bool = True, against=None,
                    keep: bool = False) -> dict:
        """3 sharded steps from the fresh state on ``meshes[key]``, by its
        route, donating or not: the log, the peak and the bytes allocated
        before the placement (``base``); with ``against`` (a placed state)
        the leaves whose pieces are not bit for bit its pieces; with
        ``keep`` the final placed state, else the readings after step 3."""
        st = meshes[key]
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        placed = shd.place(fresh(opt), st["s_sh"])
        torch.cuda.empty_cache()
        step = steps.make_sharded_train_step(model, opt, st["s_sh"], st["b_sh"],
                                             tensor_parallel=st["tp"], donate=donate)
        log = []
        torch.cuda.reset_peak_memory_stats(dev)
        with _StepSplit(dev) as split:
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if fault:
                    with (_DropPartial() if st["tp"] else _DropShard(st["dp"])):
                        placed, met = step(placed, {"tokens": b.to(dev)})
                else:
                    placed, met = step(placed, {"tokens": b.to(dev)})
                met = {k: float(v) for k, v in met.items()}
                ms = (time.perf_counter() - t0) * 1e3
                per_dev = shd.device_nbytes(placed)
                held = torch.cuda.memory_allocated(dev) - base
                log.append(dict(met, ms=ms, split=split.take(), rel=_metric_rel(met, u_log[i]),
                                bytes_ok=bool((per_dev == st["want_dev"]).all()), held=held))
        out = {"log": log, "peak": max(split.peak, torch.cuda.max_memory_allocated(dev)),
               "base": base}
        if not keep:  # a run kept for the donated one to equal is read through it
            out["readings"] = _state_readings(placed, host[-1], dev)[0]
        if against is not None:
            out["unequal"] = [
                n for (n, a), (_, b) in zip(_leaf_names(placed), _leaf_names(against))
                if not all(_same_bits(p, q) for p, q in zip(a.pieces.flat, b.pieces.flat))]
        if keep:
            out["placed"] = placed
        del placed
        torch.cuda.empty_cache()
        return out

    def donated_run(key) -> dict:
        """``sharded_run`` donating; on ``SHARD_MESH`` after the same steps
        without donation (today's step), whose final pieces it must equal
        bit for bit and whose peak it is printed beside."""
        if key[1] != SHARD_MESH:
            return sharded_run(key)
        plain = sharded_run(key, donate=False, keep=True)
        r = sharded_run(key, against=plain.pop("placed"))
        torch.cuda.empty_cache()
        r["plain_peak"] = plain["peak"] - plain["base"]
        r["plain_ms"] = statistics.median(e["ms"] for e in plain["log"][1:])
        print(f"  {key[0]} {key[1]} without donation: peak {r['plain_peak']} B over the "
              f"{plain['base']} B before its placement, step ms (median of steps 2-3) "
              f"{r['plain_ms']:.2f}; the donated run's pieces not bit for bit after "
              f"{len(batches)} steps: {r['unequal']}")
        if r["unequal"]:
            _fail(f"the donated {key} steps differ from the steps without donation: "
                  f"{r['unequal']}")
        return r

    def report(key, r):
        st, log = meshes[key], r["log"]
        peak = r["peak"] - r["base"]
        n_pieces = st["n_dev"] * len(tree_leaves(st["shapes"]))
        for i, e in enumerate(log):
            print(f"  {key[0]} {key[1]} step {i + 1}: loss {e['loss']!r} grad_norm "
                  f"{e['grad_norm']!r} (unsharded {u_log[i]['loss']!r} / "
                  f"{u_log[i]['grad_norm']!r}, relative {json.dumps(e['rel'])}) {e['ms']:.2f} ms "
                  f"synchronised; split (CUDA events, ms; the allocator's books, B) "
                  f"{json.dumps(e['split'])}; bytes a device as the specs {e['bytes_ok']}; the "
                  f"card holds {e['held']} B for the placed state "
                  f"({st['want_dev'] * st['n_dev']} B of pieces)")
        print(f"  {key[0]} {key[1]} after {len(batches)} steps against the unsharded state: "
              f"{json.dumps(r['readings'])}; peak device memory {peak} B over the {r['base']} B "
              f"allocated before the placement (reckoned {st['reck']['peak']} B)")
        for i, e in enumerate(log):
            if not e["bytes_ok"]:
                _fail(f"the {key} step changed the pieces' bytes at step {i + 1}")
            full = st["want_dev"] * st["n_dev"]
            if not full <= e["held"] <= full + 512 * n_pieces + 2**20:
                _fail(f"after {key} step {i + 1} the card holds {e['held']} B for {full} B of "
                      f"placed state")
            books = e["split"]["books"]
            fb_peak = max(m["peak"] for m in e["split"]["forward_backward_per_shard"])
            if not books["optimizer"]["peak"] <= fb_peak:
                _fail(f"{key} step {i + 1}: the update in place peaks at "
                      f"{books['optimizer']['peak']} B, over the forward and backward's "
                      f"{fb_peak} B")
        if not peak <= st["reck"]["peak"]:
            _fail(f"the {key} steps peak at {peak} B, over the reckoned {st['reck']['peak']} B")
        return statistics.median(e["ms"] for e in log[1:])

    # (1b) the gather route, donating, held bit for bit to the same steps
    # without donation; (2) the same with a planted fault
    g_key = ("gather", SHARD_MESH)
    g_run = donated_run(g_key)
    f_run = sharded_run(g_key, fault=True)
    log, readings, f_log, f_readings = g_run["log"], g_run["readings"], f_run["log"], f_run[
        "readings"]
    peak = g_run["peak"] - g_run["base"]
    ms_s = report(g_key, g_run)
    ms_u = statistics.median(e["ms"] for e in u_log[1:])
    f_rel = [e["rel"] for e in f_log]
    print(f"  planted fault (data shard 1's gradient dropped): per step {json.dumps(f_rel)}; "
          f"after {len(batches)} steps {json.dumps(f_readings)}")
    gather_tols = (SHARD_LOSS_RTOL, SHARD_GNORM_RTOL, SHARD_PARAM_SHARE, SHARD_MOMENT_RTOL)
    broken = _outside([e["rel"] for e in log], readings, gather_tols)
    broken += ["param max"] * (readings["params"]["max_abs"] > SHARD_PARAM_MAX)
    caught = _outside(f_rel, f_readings, gather_tols)
    print(f"  bounds the honest run breaks: {broken}; the planted fault's: {caught}")
    if broken:
        _fail(f"the sharded steps differ from the unsharded ones: {broken}")
    if not {"grad_norm step 1", "param share", "m", "v"} <= set(caught):
        _fail(f"the bounds do not catch a dropped data shard's gradient: {caught}")

    # (5) the tensor-parallel route on each TP_MESHES mesh (on SHARD_MESH
    # also without donation); on the first, the same with a planted fault
    tp_tols = (TP_LOSS_RTOL, TP_GNORM_RTOL, TP_PARAM_SHARE, TP_MOMENT_RTOL)
    tp_out = {}
    for dims in TP_MESHES:
        key = ("tp", dims)
        t_run = donated_run(key)
        tp_ms = report(key, t_run)
        t_broken = _outside([e["rel"] for e in t_run["log"]], t_run["readings"], tp_tols)
        tp_out[dims] = {"ms": tp_ms, "peak": t_run["peak"] - t_run["base"],
                        "plain_peak": t_run.get("plain_peak"), "plain_ms": t_run.get("plain_ms"),
                        "readings": t_run["readings"], "split": t_run["log"][-1]["split"],
                        "broken": t_broken}
        print(f"  tensor-parallel {dims}: step ms (median of steps 2-3) {tp_ms:.2f}; bounds the "
              f"honest run breaks: {t_broken}")
        if t_broken:
            _fail(f"the tensor-parallel steps on {dims} differ from the unsharded ones: "
                  f"{t_broken}")
    tf_run = sharded_run(("tp", TP_MESHES[0]), fault=True)
    tf_rel, tf_readings = [e["rel"] for e in tf_run["log"]], tf_run["readings"]
    tp_caught = _outside(tf_rel, tf_readings, tp_tols)
    print(f"  tensor-parallel planted fault (model shard 1's partial dropped from every "
          f"row-parallel sum) on {TP_MESHES[0]}: per step {json.dumps(tf_rel)}; after "
          f"{len(batches)} steps {json.dumps(tf_readings)}; bounds it breaks: {tp_caught}")
    if not {"loss step 1", "grad_norm step 1", "param share", "m", "v"} <= set(tp_caught):
        _fail(f"the bounds do not catch a dropped model shard's partial: {tp_caught}")
    print(f"  step ms (median of steps 2-3): unsharded {ms_u:.2f}, gather route {SHARD_MESH} "
          f"{ms_s:.2f} (without donation {g_run['plain_ms']:.2f}), tensor-parallel "
          + ", ".join(f"{d} {v['ms']:.2f}" for d, v in tp_out.items())
          + f"; peaks donating (without): gather {SHARD_MESH} {peak} ({g_run['plain_peak']}), "
          + ", ".join(f"tensor-parallel {d} {v['peak']} ({v['plain_peak']})"
                      for d, v in tp_out.items()))

    # (6) a (2, 1) mesh: no model axis, so no blocks: the routes bit for bit
    m21 = make_mesh((2, 1), ("data", "model"), devices=[dev] * 2)
    _, _, s21, b21 = shardings(opt, m21)
    news = []
    for tp in (False, True):
        torch.cuda.empty_cache()
        placed = shd.place(fresh(opt), s21)
        news.append(steps.make_sharded_train_step(model, opt, s21, b21, tensor_parallel=tp,
                                                  donate=True)(
            placed, {"tokens": batches[0].to(dev)}))
        del placed
    same = all(_same_bits(news[0][1][k], news[1][1][k]) for k in news[0][1])
    unequal = [i for i, (x, y) in enumerate(zip(tree_leaves(news[0][0]), tree_leaves(news[1][0])))
               if not all(_same_bits(p, q) for p, q in zip(x.pieces.flat, y.pieces.flat))]
    print(f"  (2, 1) mesh, step 1: the tensor-parallel route's metrics bit for bit the gather "
          f"route's {same}; leaves not bit for bit {unequal}")
    del news
    torch.cuda.empty_cache()
    if not same or unequal:
        _fail(f"on a (2, 1) mesh the tensor-parallel step differs from the gather route: "
              f"{unequal}")
    del host[-1]

    # (3) step 2 on a (1, 1) mesh from the unsharded step 1's state
    _, _, s1_sh, b1_sh = shardings(opt, one)
    torch.cuda.empty_cache()
    placed = shd.place(host[0], s1_sh)
    new, met = steps.make_sharded_train_step(model, opt, s1_sh, b1_sh, donate=True)(
        placed, {"tokens": batches[1].to(dev)})
    met = {k: float(v) for k, v in met.items()}
    r11, unequal = _state_readings(new, host[1], dev)
    index_leaves = {f"{g}.{n}" for g in ("params", "m", "v") for n in ("embed", "lm_head")}
    same_metrics = met["loss"] == u_log[1]["loss"] and met["grad_norm"] == u_log[1]["grad_norm"]
    print(f"  (1, 1) mesh, step 2: loss {met['loss']!r} grad_norm {met['grad_norm']!r}, equal "
          f"to the unsharded step's bit for bit {same_metrics}; leaves not bit for bit "
          f"{unequal}; readings {json.dumps(r11)}")
    del placed, new
    host.clear()
    torch.cuda.empty_cache()
    if not same_metrics or set(unequal) - index_leaves:
        _fail(f"the (1, 1) step differs from the unsharded step beyond the embedding and head: "
              f"{unequal}")
    if not all(r11[k]["max_rel"] <= SHARD_MOMENT_RTOL for k in ("m", "v")):
        _fail(f"the (1, 1) step's embedding or head moments are outside the bound: {r11}")

    # (4) quantized moments, one step on the (2, 2) mesh
    _, q_specs, q_sh, qb_sh = shardings(opt_q, mesh)
    with use_mesh(mesh):
        want_q, want_m = steps.make_train_step(model, opt_q)(
            fresh(opt_q), {"tokens": batches[0].to(dev)})
    placed = shd.place(fresh(opt_q), q_sh)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, met = steps.make_sharded_train_step(model, opt_q, q_sh, qb_sh, donate=True)(
        placed, {"tokens": batches[0].to(dev)})
    met = {k: float(v) for k, v in met.items()}
    q_ms = (time.perf_counter() - t0) * 1e3
    q_rel = _metric_rel(met, {k: float(v) for k, v in want_m.items()})
    rq, _ = _state_readings(new, want_q, dev)
    print(f"  quantized moments, one (2, 2) step ({q_ms:.2f} ms, the first call): loss "
          f"{met['loss']!r} grad_norm {met['grad_norm']!r}, relative {json.dumps(q_rel)}; "
          f"readings {json.dumps(rq)}")
    del placed, new, want_q
    torch.cuda.empty_cache()
    # bf16 m, int8 v_q (symbols over the largest) and v_scale, as the f32 moments
    if not (q_rel["loss"] <= SHARD_LOSS_RTOL and q_rel["grad_norm"] <= SHARD_GNORM_RTOL
            and all(rq[k]["max_rel"] <= SHARD_MOMENT_RTOL for k in ("m", "v_q", "v_scale"))):
        _fail(f"the quantized sharded step differs from the unsharded one: {q_rel}, {rq}")

    # (7) the ssm, hybrid and audio families on the tensor-parallel route
    families = _shardtrain_tp_families(dev)

    launches = {n: fn.launches for n, fn in wrappers.items()}
    print(f"  kernel launches during the phase: {launches}")
    if any(launches.values()):
        _fail(f"the sharded train step launched a kernel: {launches}")
    out = {"sharded_ms": ms_s, "unsharded_ms": ms_u, "peak_bytes": peak, "reckoned": reck,
           "readings": readings, "fault_readings": f_readings, "tensor_parallel": tp_out,
           "tp_fault_readings": tf_readings, "families": families,
           "phase_s": time.perf_counter() - t_phase}
    print(f"  shardtrain phase {out['phase_s']:.1f} s")
    return out


# the ssm, hybrid and audio families on the tensor-parallel train route (the
# shardtrain phase's last part): (arch, config overrides) at full width,
# falcon-mamba cut to 4 of its 64 layers and zamba2 to one segment (6
# Mamba-2 layers and the shared block), whisper-tiny whole; AdamW on the
# train phase's schedule, TP_FAM_BATCH x TP_FAM_SEQ tokens a step (whisper
# over encoder_seq random frames a row)
TP_FAM_TRAIN = (("falcon-mamba-7b", {"n_layers": 4}), ("zamba2-2.7b", {"n_layers": 6}),
                ("whisper-tiny", {}))
TP_FAM_BATCH, TP_FAM_SEQ = 4, 512
# the planted fault of each family: model shard 1's partial dropped from
# its new reductions (``models/ssm``'s and ``models/whisper``'s functions)
TP_FAM_FAULTS = {"ssm": ("_x_proj_split", "_out_proj_split"),
                 "hybrid": ("_gate_norm_split", "_out_proj_split"),
                 "audio": ("_cross_attend_split",)}
# bounds against the unsharded steps, (loss, grad norm, param share,
# moments): stablelm's ``TP_*`` hold, each between the honest runs'
# readings on (2, 2) and (1, 4) over the three families and the planted
# faults' on (2, 2), in brackets (an NVIDIA H100 80GB HBM3 at 700 W):
# loss [3.6e-5 falcon-mamba, 6.5e-5 zamba2, 1.5e-5 whisper; 6.1e-4-2.8e-3
# at step 1], grad norm [8.4e-4; 8.0e-3-1.4e-2 at step 1], param share
# [0.346; 0.51-0.82], moments [0.062; 1.3-2.4]
TP_FAM_TOLS = (TP_LOSS_RTOL, TP_GNORM_RTOL, TP_PARAM_SHARE, TP_MOMENT_RTOL)


def _shardtrain_tp_families(dev) -> dict:
    """``TP_FAM_TRAIN`` one after the other: 3 unsharded steps (the state
    after step 3 kept on the host), then 3 sharded steps from the same
    state on the gather route on (2, 2) (its times) and on the
    tensor-parallel route on (2, 2) and (1, 4), each held to the unsharded
    steps by ``TP_FAM_TOLS``, the bytes a device the specs' after every
    step; and 3 tensor-parallel steps on (2, 2) with ``TP_FAM_FAULTS``,
    which must break them. The sharded steps donate. Step ms: the median
    of steps 2-3."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.lm import token_batches
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.util import use_mesh

    opt = adamw(linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    out = {}
    for arch, kw in TP_FAM_TRAIN:
        t_fam = time.perf_counter()
        cfg = get_arch(arch).with_(**kw)
        model = build_model(cfg)
        data = token_batches(cfg.vocab_size, TP_FAM_BATCH, TP_FAM_SEQ, seed=0)
        rng = np.random.RandomState(0)
        batches = []
        for _ in range(3):
            b = {"tokens": torch.as_tensor(next(data)["tokens"], device=dev)}
            if cfg.family == "audio":
                b["frames"] = torch.as_tensor(rng.randn(
                    TP_FAM_BATCH, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32),
                    device=dev)
            batches.append(b)
        gen = torch.Generator(device=dev)

        def fresh():
            gen.manual_seed(0)
            return steps.init_train_state(model, opt, gen)

        def shardings(m):
            shapes = steps.train_state_shapes(model, opt)
            specs = {"params": shd.tree_param_specs(shapes["params"], m,
                                                    n_kv_heads=cfg.n_kv_heads),
                     "opt": {k: shd.tree_param_specs(v, m, n_kv_heads=cfg.n_kv_heads)
                             for k, v in shapes["opt"].items()}, "step": shd.P()}
            return (shd.to_named(specs, m), shd.to_named(shd.batch_spec(batches[0], m), m),
                    shd.tree_spec_nbytes(shapes, specs, m))

        meshes = {dims: make_mesh(dims, ("data", "model"), devices=[dev] * 4)
                  for dims in ((2, 2), (1, 4))}
        torch.cuda.empty_cache()
        state = fresh()
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        ref = steps.make_train_step(model, opt)
        u_log = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_mesh(meshes[(2, 2)]):
                state, met = ref(state, b)
            met = {k: float(v) for k, v in met.items()}
            u_log.append(dict(met, ms=(time.perf_counter() - t0) * 1e3))
        want_state = state  # kept on the card (a few GB at these depths)
        del met
        torch.cuda.empty_cache()

        def run(dims, tp: bool, fault=None):
            s_sh, b_sh, want_dev = shardings(meshes[dims])
            placed = shd.place(fresh(), s_sh)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            step = steps.make_sharded_train_step(model, opt, s_sh, b_sh, tensor_parallel=tp,
                                                 donate=True)
            log = []
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (_DropPartial(callers=fault) if fault else contextlib.nullcontext()):
                    placed, met = step(placed, b)
                met = {k: float(v) for k, v in met.items()}
                log.append(dict(met, ms=(time.perf_counter() - t0) * 1e3,
                                rel=_metric_rel(met, u_log[i]),
                                bytes_ok=bool((shd.device_nbytes(placed) == want_dev).all())))
            peak = torch.cuda.max_memory_allocated(dev)
            readings, _ = _state_readings(placed, want_state, dev)
            del placed
            torch.cuda.empty_cache()
            return {"ms": statistics.median(e["ms"] for e in log[1:]), "log": log, "peak": peak,
                    "readings": readings, "bytes_a_device": want_dev,
                    "broken": _outside([e["rel"] for e in log], readings, TP_FAM_TOLS)}

        res = {"unsharded_ms": statistics.median(e["ms"] for e in u_log[1:]), "n_params": n_params,
               "gather": run((2, 2), False), "tp": {d: run(d, True) for d in meshes},
               "fault": run((2, 2), True, TP_FAM_FAULTS[cfg.family])}
        del want_state, state
        res["s"] = time.perf_counter() - t_fam
        print(f"  {cfg.name} ({cfg.n_layers} layers, {n_params} params) tensor-parallel train, "
              f"{TP_FAM_BATCH} x {TP_FAM_SEQ} tokens a step: step ms unsharded "
              f"{res['unsharded_ms']:.2f}, gather (2, 2) {res['gather']['ms']:.2f}, "
              f"tensor-parallel " + ", ".join(f"{d} {r['ms']:.2f}" for d, r in res["tp"].items())
              + f"; placed state a device " + ", ".join(
                  f"{d} {r['bytes_a_device']} B" for d, r in res["tp"].items())
              + "; peak " + ", ".join(f"{d} {r['peak']} B" for d, r in res["tp"].items())
              + f" ({res['s']:.1f} s)")
        for name, r in (("gather (2, 2)", res["gather"]), *((f"tp {d}", r) for d, r in
                                                            res["tp"].items()),
                        (f"fault {TP_FAM_FAULTS[cfg.family]}", res["fault"])):
            print(f"    {name}: per step {json.dumps([e['rel'] for e in r['log']])}; after 3 "
                  f"steps {json.dumps(r['readings'])}; bounds broken {r['broken']}")
        for d, r in res["tp"].items():
            if r["broken"] or not all(e["bytes_ok"] for e in r["log"]):
                _fail(f"{cfg.name}'s tensor-parallel steps on {d} differ from the unsharded "
                      f"ones or change the pieces' bytes: {r['broken']}")
        if not {"grad_norm step 1", "m", "v"} <= set(res["fault"]["broken"]):
            _fail(f"the bounds do not catch {cfg.name}'s dropped partial: "
                  f"{res['fault']['broken']}")
        out[cfg.name] = res
        del model, batches
        torch.cuda.empty_cache()
    return out


def phase_tpfamilies(dev):
    """The ssm, hybrid and audio families' tensor-parallel parts of the
    shardtrain and serve phases alone (not in a full run: ``--phases
    build,tpfamilies``), every check read to the end before the run
    fails."""
    global _fail
    fails = []
    _fail, exit_on = fails.append, _fail
    try:
        _shardtrain_tp_families(dev)
        _serve_tp_families(dev)
    finally:
        _fail = exit_on
    for msg in fails[:-1]:
        print(f"FAIL: {msg}", file=sys.stderr)
    if fails:
        _fail(fails[-1])


def phase_shardprof(dev):
    """Where the sharded step's time goes, data shard pass by pass (not in
    a full run: ``--phases build,shardprof``; after the full list of
    phases it runs on their history). The shardtrain phase's step (stablelm-1.6b,
    AdamW, the (2, 2) mesh of four shards of the card), by each route (the
    gather route, then the tensor-parallel one): one step to warm
    up, then 3 under ``torch.profiler``, each pass
    (``steps.shard_value_and_grad``: gathers, forward and backward) fenced
    by synchronisations, while ``nvidia-smi`` samples the SM clock and the
    power every 50 ms. Per pass: wall ms, the device's busy ms, kernel ms
    by class, the matmul kernels' names, the cudaMalloc and cudaFree calls
    and their host ms, the allocator's retries, the host's garbage
    collections, and the SM clock and power sampled within it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import token_batches
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine

    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    dp, mp = SHARD_MESH
    mesh = make_mesh(SHARD_MESH, ("data", "model"), devices=[dev] * (dp * mp))
    opt = adamw(linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    data = token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [{"tokens": torch.as_tensor(next(data)["tokens"], device=dev)} for _ in range(4)]
    shapes = steps.train_state_shapes(model, opt)
    specs = {"params": shd.tree_param_specs(shapes["params"], mesh, n_kv_heads=cfg.n_kv_heads),
             "opt": {k: shd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                     for k, v in shapes["opt"].items()}, "step": shd.P()}
    s_sh = shd.to_named(specs, mesh)
    b_sh = shd.to_named(shd.batch_spec(batches[0], mesh), mesh)
    gen = torch.Generator(device=dev)
    return {tp: _shardprof_route(dev, cfg, model, opt, batches, s_sh, b_sh, gen, tp)
            for tp in (False, True)}


def _shardprof_route(dev, cfg, model, opt, batches, s_sh, b_sh, gen, tp: bool) -> list:
    """``phase_shardprof``'s profile of one route."""
    import datetime
    import signal

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps

    dp, mp = SHARD_MESH
    gen.manual_seed(0)
    torch.cuda.empty_cache()
    placed = shd.place(steps.init_train_state(model, opt, gen), s_sh)
    step = steps.make_sharded_train_step(model, opt, s_sh, b_sh, tensor_parallel=tp,
                                         donate=True)

    real, passes = steps.shard_value_and_grad, []

    def books():
        s = torch.cuda.memory_stats(dev)
        return (s.get("num_device_alloc", s.get("segment.all.allocated", 0)),
                s.get("num_alloc_retries", 0)) + gc_clock.read()

    def fenced(*a, **kw):
        torch.cuda.synchronize()
        b0, t0 = books(), time.time()
        with record_function(f"shard_pass_{len(passes)}"):
            out = real(*a, **kw)
            torch.cuda.synchronize()
        b1 = books()
        passes.append({"t": (t0, time.time()), "mallocs": b1[0] - b0[0],
                       "retries": b1[1] - b0[1], "gc_ms": b1[2] - b0[2],
                       "gc_full": b1[3] - b0[3]})
        return out

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    steps.shard_value_and_grad = fenced
    gc_clock = _GcClock().__enter__()
    try:
        placed, met = step(placed, batches[0])
        float(met["loss"])
        passes.clear()
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in batches[1:]:
                t0 = time.perf_counter()
                placed, met = step(placed, b)
                float(met["loss"])
                walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        steps.shard_value_and_grad = real
        gc_clock.__exit__()
        smi.send_signal(signal.SIGINT)  # its loop ends and flushes on an interrupt
        try:
            samples_txt = smi.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            smi.kill()
            samples_txt = smi.communicate()[0]
    samples = []
    for line in samples_txt.splitlines():
        try:
            ts, clock, power = (x.strip() for x in line.split(","))
            t = datetime.datetime.strptime(ts, "%Y/%m/%d %H:%M:%S.%f").timestamp()
            samples.append((t, float(clock), float(power)))
        except ValueError:
            continue
    events = prof.events()
    marks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name.startswith("shard_pass_") and e.device_type.name == "CPU")
    kernels = [e for e in events  # the passes' own marks show on the device too
               if e.device_type.name == "CUDA" and not e.name.startswith("shard_pass_")]
    runtime = [e for e in events if e.name in ("cudaMalloc", "cudaFree")]
    print(f"shardprof ({'tensor-parallel' if tp else 'gather'} route): {cfg.name} at full "
          f"width, {dp} x {mp} mesh of {dev} x {dp * mp}; "
          f"{len(walls)} profiled steps, wall ms {walls!r}; {len(samples)} nvidia-smi samples")
    out = []
    for i, ((s0, s1), rec) in enumerate(zip(marks, passes)):
        ks = [k for k in kernels if s0 <= k.time_range.start < s1]
        by_class = {}
        for k in ks:
            c = _kernel_class(k.name)
            by_class[c] = round(by_class.get(c, 0.0)
                                + (k.time_range.end - k.time_range.start) / 1e3, 3)
        gemms = sorted({k.name[:80] for k in ks if _kernel_class(k.name) == "matmul"})
        rt = [e for e in runtime if s0 <= e.time_range.start < s1]
        near = [(c, w) for t, c, w in samples if rec["t"][0] <= t <= rec["t"][1]]
        row = {"pass": i, "wall_ms": (s1 - s0) / 1e3,
               "busy_ms": _busy_us([(k.time_range.start, k.time_range.end) for k in ks]) / 1e3,
               "kernels": len(ks), "ms_by_class": by_class,
               "cudaMalloc": sum(e.name == "cudaMalloc" for e in rt),
               "cudaFree": sum(e.name == "cudaFree" for e in rt),
               "malloc_free_host_ms": sum(e.time_range.end - e.time_range.start
                                          for e in rt) / 1e3,
               "allocator_mallocs": rec["mallocs"], "retries": rec["retries"],
               "gc_ms": rec["gc_ms"], "gc_full": rec["gc_full"],
               "sm_mhz": [c for c, _ in near], "power_w": [w for _, w in near],
               "matmul_kernels": gemms}
        out.append(row)
        print(f"  pass {i}: {json.dumps({k: v for k, v in row.items() if k != 'matmul_kernels'})}")
    names = [set(r["matmul_kernels"]) for r in out]
    print(f"  matmul kernels the same in every pass: {all(n == names[0] for n in names)}; "
          f"pass 0's: {sorted(names[0]) if names else []}")
    del placed
    torch.cuda.empty_cache()
    return out


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _kernel_class(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if any(k in n for k in ("index", "scatter", "gather", "sort", "radix")):
        return "index"
    if any(k in n for k in ("reduce", "softmax", "norm")):
        return "reduce"
    if "copy" in n or "cat" in n:
        return "copy"
    return "elementwise"


def phase_trainprof(dev):
    """Where a full-width training step's device time goes (not in a full
    run: ``--phases build,trainprof``). One steady AdamW step of
    stablelm-1.6b (4 x 2,048 tokens, remat) under ``torch.profiler``: the
    device's busy and idle share of the step and its kernel time by class
    and by name; the chunked attention of one layer forward, and forward
    with backward, at the step's shapes (CUDA events), times the layers;
    and the step with the stacked layer leaves indexed layer by layer in
    place of unbound once, in turns (step ms and peak memory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import token_batches
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine

    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    opt = adamw(linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(model, opt, gen)
    step_fn = make_train_step(model, opt)
    batch = {"tokens": torch.as_tensor(
        next(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0))["tokens"], device=dev)}

    def one_step():
        new, m = step_fn(state, batch)
        float(m["loss"])
        del new

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None and e.device_type.name == "CUDA"]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_class, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        c = _kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        rec = by_name.setdefault(e.name[:90], [0, 0.0])
        rec[0] += 1
        rec[1] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(f"trainprof: one steady step under torch.profiler: wall {wall_us / 1e3:.2f} ms, "
          f"{len(kernels)} kernels, device busy {busy / 1e3:.2f} ms, idle share "
          f"{1 - busy / wall_us:.4f}")
    print(f"  kernel ms by class: {json.dumps({k: round(v, 3) for k, v in by_class.items()})}")
    for name, (count, ms) in top:
        print(f"  {ms:10.3f} ms {count:6d} x {name}")

    # one layer's chunked attention at the step's shapes
    H, Dh = cfg.n_heads, cfg.resolved_head_dim()
    shape = (TRAIN_BATCH, TRAIN_SEQ, H, Dh)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    g = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    def fwd():
        return L.chunked_attention(q, k, v, q_chunk=cfg.attn_chunk, k_chunk=cfg.attn_chunk)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), g)

    f_ms, fb_ms = cuda_ms(fwd, reps=5, warmup=1), cuda_ms(fwd_bwd, reps=5, warmup=1)
    attn_step = cfg.n_layers * (f_ms + fb_ms)  # forward, then remat's recompute + backward
    print(f"  chunked attention, one layer (B {TRAIN_BATCH}, S {TRAIN_SEQ}, H {H}, D {Dh}): "
          f"forward {f_ms:.3f} ms, forward+backward {fb_ms:.3f} ms; x {cfg.n_layers} layers "
          f"with remat: {attn_step:.2f} ms a step")
    del q, k, v, g

    # the stacked leaves unbound once (shipped) against indexed layer by layer
    def timed():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        one_step()
        return (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated(dev)

    shipped = TF._unstack
    indexed = lambda stacked, n: [TF._layer(stacked, i) for i in range(n)]  # noqa: E731
    readings = []
    for name, fn in (("unbind", shipped), ("index", indexed), ("index", indexed),
                     ("unbind", shipped)):
        TF._unstack = fn
        readings.append((name,) + timed())
    TF._unstack = shipped
    print(f"  stacked leaves per step, in turns (variant, step ms, peak B): {readings!r}")
    del state
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, by_class=by_class,
                attn_step_ms=attn_step, readings=readings)


def _leaf_names(tree, prefix=""):
    """(dotted name, leaf) in flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)
        return out
    return [(prefix, tree)]


# ---------------------------------------------------------------- main


# a full run's phases; ``--phases`` may also name ``rows`` (phase_rows),
# ``trainprof`` (phase_trainprof) and ``shardprof`` (phase_shardprof), which a
# full run leaves out
PHASES = ("build", "kernels", "rounds", "state", "mesh", "flat", "stream", "ops", "host",
          "serve", "families", "zoo", "train", "shardtrain")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible: the chip smoke test needs one card",
              file=sys.stderr)
        sys.exit(2)

    dev = torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    errs = {}
    if "kernels" in phases:
        M = _ds2_layout_size(dev)
        errs.update(check_ota(M, dev, timing=True))
        errs.update(check_topk(dev, timing=True))
        errs.update(check_qs(M, dev))
        flash_err, flash_rec = check_flash(dev, timing=True)
        errs.update(flash_err)
    plan_bits = [8] * 20
    for name in ("state", "mesh"):
        if name in phases and "rounds" not in phases:
            _fail(f"the {name} phase runs on the rounds phase's server: name both")
    if "rounds" in phases:
        srv, counts, round_inputs = phase_rounds(dev)
        timings = time_round_kernels(srv, round_inputs, dev)
        plan_bits = list(srv.round_logs[-1].bits.values())
        if "state" in phases:
            state_counts, _ = phase_state(srv, dev)
        if "mesh" in phases:
            mesh_counts = phase_mesh(srv, round_inputs, dev)
        del srv, round_inputs
    if "flat" in phases:
        qs_launches, qs_err, qs_rec = phase_flat(dev, plan_bits)
    if "stream" in phases:
        stream_counts = phase_stream(dev)
    if "ops" in phases:
        ops_counts, ops_errs, ops_rows = phase_ops(dev)
    if "host" in phases:
        host_us_per_call(dev)
    if "rows" in phases:
        phase_rows(dev)
    if "serve" in phases:
        serve_rec = phase_serve(dev)
    if "families" in phases:
        families_rec = phase_families(dev)
    if "zoo" in phases:
        zoo_rec = phase_zoo(dev)
    if "train" in phases:
        phase_train(dev)
    if "shardtrain" in phases:
        phase_shardtrain(dev)
    if "trainprof" in phases:
        phase_trainprof(dev)
    if "shardprof" in phases:
        phase_shardprof(dev)
    if "tpfamilies" in phases:
        phase_tpfamilies(dev)
    if set(phases) != set(PHASES):
        print(f"partial run ({args.phases}) done in {time.perf_counter() - t_start:.1f} s")
        return

    sources = {"ota_superpose": "src/repro_torch/csrc/ota_superpose.cu",
               "ota_fold": "src/repro_torch/csrc/ota_superpose.cu",
               "topk_cosine": "src/repro_torch/csrc/topk_cosine.cu",
               "ota_quantize_superpose": "src/repro_torch/csrc/ota_quantize_superpose.cu",
               "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
               "fake_quant": "src/repro_torch/csrc/fake_quant.cu",
               "qmatmul": "src/repro_torch/csrc/qmatmul.cu",
               "ota_aggregate": "src/repro_torch/csrc/ota_aggregate.cu"}
    replaces = {"ota_superpose": "src/repro/kernels/ota_fused.py:288",
                "ota_fold": "src/repro/kernels/ota_fused.py:334",
                "topk_cosine": "src/repro/kernels/topk_similarity.py:83",
                "ota_quantize_superpose": "src/repro/kernels/ota_fused.py:379",
                "flash_attention": "src/repro/kernels/flash_attention.py:87",
                "fake_quant": "src/repro/kernels/quantize.py:42",
                "qmatmul": "src/repro/kernels/qmatmul.py:42",
                "ota_aggregate": "src/repro/kernels/ota_aggregate.py:32"}
    timings["ota_quantize_superpose"] = qs_rec
    timings["flash_attention"] = flash_rec
    timings.update(ops_rows)
    # each path's count, read just after the path ran, summed over the paths
    launches = {n: counts[n] + stream_counts[n] for n in counts}
    launches["ota_quantize_superpose"] = qs_launches
    for n, c in (*state_counts.items(), *mesh_counts.items()):
        launches[n] += c
    launches["flash_attention"] = (serve_rec["launches"] + families_rec["launches"]
                                   + zoo_rec["flash_launches"])
    for n, c in ops_counts.items():
        launches[n] = launches.get(n, 0) + c
    errs["ota_quantize_superpose"] = max(errs["ota_quantize_superpose"], qs_err)
    errs["flash_attention"] = max(errs["flash_attention"], serve_rec["flash_max_abs_err"])
    for n, e in ops_errs.items():
        errs[n] = max(errs.get(n, 0.0), e)
    kernels = []
    for name in sources:
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"smoke test done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
