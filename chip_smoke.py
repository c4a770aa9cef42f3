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
             (log-softmax within SERVE_LOGIT_TOL); ``ServeEngine`` on the same
             params (max_batch 4, cache_len 256) draining 8 requests.

The ``kernels`` phase also holds the quantize-superpose kernel against its
plain version over every width 2-31 and 32, K in {1, 7, 20}, aligned and
ragged M, and the flash kernel against its plain version at every
FLASH_CASES shape: the serve phase's (B 4, S 2,048, H 32, KV 8, D 128,
bf16), a ragged S = 2,000, StableLM-1.6B's widths (MHA, D 64), two f32
cases, and the other configs' widths and masks (zamba2-2.7b D 80,
kimi-k2-1t-a32b 64/8 heads of 112, Qwen3-8B non-causal, whisper-tiny's
encoder keys cut to a tile-aligned 1,536, causal Sq > Sk, f32 D 32, a
zero-padded D 40), element by element and by the share of elements that
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
seconds a tree, to compare two trees in one call.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32, outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16, dense, on the tensor cores
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
# through ``ops.flash_mha`` in the ops phase too (OPS_FLASH_CASES)
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


def phase_rounds(dev):
    import torch

    from repro_torch import obs
    from repro_torch.configs import FLConfig, QUANT_BLOCK
    from repro_torch.core import ota, packing
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.server import FLServer
    from repro_torch.kernels import ota_fused as kota
    from repro_torch.kernels import topk_similarity as ktk

    # FedAvgM with the velocity kept in bf16: the state phase checkpoints it
    cfg = FLConfig(n_clients=20, clients_per_round=20, seed=0, server_momentum=0.9,
                   quantize_server_state=True)
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
        round_inputs.append((rows, w))
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

    rows, w = round_inputs[-1]
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
    return dict(timing, launches=launches, prompt_tokens=prompt_toks, engine_s=secs,
                max_dlogsoftmax=dmax, peak_bytes=peak)


# ---------------------------------------------------------------- main


# a full run's phases; ``--phases`` may also name ``rows`` (phase_rows), which
# a full run leaves out
PHASES = ("build", "kernels", "rounds", "state", "flat", "stream", "ops", "host", "serve")


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
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

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
    if "state" in phases and "rounds" not in phases:
        _fail("the state phase runs on the rounds phase's server: name both")
    if "rounds" in phases:
        srv, counts, round_inputs = phase_rounds(dev)
        timings = time_round_kernels(srv, round_inputs, dev)
        plan_bits = list(srv.round_logs[-1].bits.values())
        if "state" in phases:
            state_counts, _ = phase_state(srv, dev)
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
    for n, c in state_counts.items():
        launches[n] += c
    launches["flash_attention"] = serve_rec["launches"]
    for n, c in ops_counts.items():
        launches[n] = launches.get(n, 0) + c
    errs["ota_quantize_superpose"] = max(errs["ota_quantize_superpose"], qs_err)
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
