#!/usr/bin/env python3
"""Readings behind the flash kernel's two tolerances in ``chip_smoke.py``.

    python3 scripts/flash_tolerance_probe.py [--out chiprun_out/flash_probe.json]

Needs one CUDA card. Three parts:

1. Kernel against plain version (``kernels/flash_attention.mismatch``) at
   every ``chip_smoke.FLASH_CASES`` shape (causal and not, Sq == Sk and
   Sq != Sk, D in {32, 40 (zero-padded), 64, 80, 112, 128}), from the same
   seed as the ``kernels`` phase: per element the difference in ulps of the
   plain output's own magnitude (a histogram), the largest excess over 2
   ulps, and the share of elements that differ. Beside the sound kernel,
   the same readings for planted faults: versions of the plain computation
   with one fault each (a key tile dropped, one tile's accumulator not
   rescaled, p left in f32 before PV, the scale rounded to bf16; with the
   causal mask also the mask one key ahead and, where Sq != Sk, the mask
   aligned bottom-right instead of top-left), held against the true plain
   version. At the float32 cases also planted faults of f32 on the tensor
   cores' bf16 plane products (``split3_attention``, a plain model):
   PV as one bf16 pass (p's and v's hi planes alone), the (mid, mid) pair
   dropped, p not split (rounded to one bf16); and two readings of the rule
   itself: an f64 reference (the exact result) and the scores as the six
   plane products (``qk_pairs``), each against the plain version.
2. The serve phase's end-to-end check at full Qwen3-8B width: max
   |log_softmax(prefill) - log_softmax(chunked prefill)| over the last
   position's logits, and the top-1 agreement, for the kernel, the plain
   version and each planted fault in place of ``flash_mha``.
3. The share's resolution on a small output: the
   ``tests/test_torch_kernels_cuda.py`` Hopper cases with at most 2,048
   output elements (``SMALL_CASES``: one query row over one key, causal,
   and over 256 keys without the mask, 8 heads; 8 D elements), at every
   bf16 width, over SMALL_SEEDS seeds (``--small-seeds``) and at the
   test's own draw: the count
   of elements that differ from the plain version, for (a) the kernel,
   (b) the same source built under ``build/flash_probe/`` with
   flash_fwd_hopper's softmax rounded as the plain version's
   (``PLAIN_ROUNDING``: expf(s scale - m) and expf(m - m') in place of the
   base-2 form), and (c) the planted bf16 faults (p left in f32, the scale
   rounded to bf16, a dropped key tile); then (b)'s time beside (a)'s at
   the serve layer (Qwen3-8B, B 4 x 2,048), queued, in turns. One rounding
   flip of a p moves its row's output at every column, so the differing
   elements come in clusters, and at 8 D elements a cluster of three reads
   above TOL_SHARE. The summary gives the largest count of (a), the seeds
   each of (a) and (b) fails under the 1% share, the smallest count of any
   fault that changes something, per head width (``per_d``) (a)'s
   largest count, (c)'s smallest and the floor ``small_floor`` gives, and
   the draws of (a) and of the faults that ``mismatch`` (the share or the
   floor) calls within and beyond.

``--parts`` runs a subset (``kernel``, ``serve``, ``small``).

Prints one line per reading and writes all of them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAULTS = ("drop_tile", "no_rescale", "mask_one_ahead", "p_f32", "scale_bf16", "bottom_right")
ULP_BINS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0, float("inf"))
SMALL_SEEDS = 200
# the Hopper card cases of at most 2,048 output elements (B, Sq, Sk, H, KV,
# causal), each at every bf16 width; drawn as the test draws them
SMALL_CASES = ((1, 1, 1, 8, 1, True), (1, 1, 256, 8, 8, False))
SMALL_FAULTS = ("p_f32", "scale_bf16", "drop_tile")
# flash_fwd_hopper's softmax rounded as the plain version's: scores times
# the scale alone, expf in place of exp2f
PLAIN_ROUNDING = (
    ("const float scale2 = scale * 1.4426950408889634f;", "const float scale2 = scale;"),
    ("corr[r] = exp2f(m_run[r] - mx[r]);", "corr[r] = expf(m_run[r] - mx[r]);"),
    ("s[i] = exp2f(s[i] - mx[(i >> 1) & 1]);", "s[i] = expf(s[i] - mx[(i >> 1) & 1]);"),
)
# the plane pairs of f32 on the tensor cores (A's plane, B's plane; 0 hi, 1
# mid, 2 lo; kernels/qmatmul.split3_plain), small first: a product of two
# bf16 planes is exact in f32, and (mid, lo), (lo, mid) and (lo, lo),
# dropped, are under 2**-20 of each term's |a| |b| together
SPLIT3_PAIRS = ((0, 2), (1, 1), (0, 1), (2, 0), (1, 0), (0, 0))
# planted faults of f32 PV on the tensor cores' plane products
F32_FAULTS = {
    "one_pass": dict(pairs=((0, 0),)),
    "no_midmid": dict(pairs=((0, 2), (0, 1), (2, 0), (1, 0), (0, 0))),
    "p_unsplit": dict(split_p=False),
}


def split3_attention(q, k, v, *, causal=True, pairs=SPLIT3_PAIRS, split_p=True, qk_pairs=None):
    """A plain model of f32 attention on the tensor cores, which the f32
    route (``flash_fwd_f32_hopper``, on the CUDA cores) does not take; the
    f32 part of ``kernel_readings`` reads its planted faults against the
    rule, and ``tests/test_torch_flash.py`` holds it to the rule at small
    shapes. ``flash_attention_plain`` on float32 q, k, v with each key
    tile's PV the f32 sum of the plane pairs in ``pairs`` of p's and v's
    three bf16 planes (``split3_plain``; a product of two planes is exact
    in f32), added as acc * corr + pv, and with ``qk_pairs`` the scores
    likewise from q's and k's planes (else the plain version's f32 scores).
    It models the terms, not a tensor core's bits. ``split_p=False`` takes
    p rounded to one bf16 in place of its planes."""
    import torch

    from repro_torch.kernels.flash_attention import BK, NEG_INF
    from repro_torch.kernels.qmatmul import split3_plain

    if q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError("the three-plane model takes float32 q, k, v")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D**-0.5

    def planes(x):
        return [t.to(torch.float32) for t in split3_plain(x)]

    def pair_sum(spec, a, b, pairs):
        out = None
        for i, j in pairs:
            t = torch.einsum(spec, a[i], b[j])
            out = t if out is None else out + t
        return out

    qf = q.permute(0, 2, 1, 3).reshape(B, KV, G, Sq, D)
    kf = k.permute(0, 2, 1, 3)  # (B, KV, Sk, D)
    if qk_pairs is not None:
        qp, kp = planes(qf), planes(kf)
    vp = planes(v.permute(0, 2, 1, 3))
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    for k0 in range(0, Sk, BK):
        k1 = min(k0 + BK, Sk)
        r0 = k0 if causal else 0
        if r0 >= Sq:
            break
        if qk_pairs is None:
            s = torch.einsum("bkgqd,bkcd->bkgqc", qf[:, :, :, r0:], kf[:, :, k0:k1]) * scale
        else:
            s = pair_sum("bkgqd,bkcd->bkgqc", [x[:, :, :, r0:] for x in qp],
                         [x[:, :, k0:k1] for x in kp], qk_pairs) * scale
        if causal:
            mask = qpos[r0:, None] >= kpos[None, k0:k1]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_prev = m[..., r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l[..., r0:] = l[..., r0:] * corr + p.sum(dim=-1)
        if split_p:
            pp = planes(p)
        else:
            pp = [p.to(torch.bfloat16).to(torch.float32), torch.zeros_like(p),
                  torch.zeros_like(p)]
        pv = pair_sum("bkgqc,bkcd->bkgqd", pp, [x[:, :, k0:k1] for x in vp], pairs)
        acc[..., r0:, :] = acc[..., r0:, :] * corr[..., None] + pv
        m[..., r0:] = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3).contiguous()


def plain_with_fault(q, k, v, fault, causal=True):
    """``flash_attention_plain`` with one planted fault (None: none). The
    faulty tile (dropped or not rescaled) is the middle one of the row."""
    import torch

    from repro_torch.kernels.flash_attention import BK, NEG_INF

    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D**-0.5
    if fault == "scale_bf16":
        scale = float(torch.tensor(scale, dtype=torch.bfloat16))
    bad_tile = (-(-Sk // BK)) // 2
    qf = q.permute(0, 2, 1, 3).reshape(B, KV, G, Sq, D).to(torch.float32)
    kf = k.permute(0, 2, 1, 3).to(torch.float32)
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    # row i sees keys j <= i + off: 0 is the reference's top-left mask
    off = {"mask_one_ahead": 1, "bottom_right": Sk - Sq}.get(fault, 0)
    for t, k0 in enumerate(range(0, Sk, BK)):
        if fault == "drop_tile" and t == bad_tile:
            continue
        k1 = min(k0 + BK, Sk)
        r0 = min(max(k0 - off, 0), Sq) if causal else 0
        qs = qf[:, :, :, r0:]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qs, kf[:, :, k0:k1]) * scale
        if causal:
            mask = qpos[r0:, None] + off >= kpos[None, k0:k1]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_prev = m[..., r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l[..., r0:] = l[..., r0:] * corr + p.sum(dim=-1)
        pr = p if fault == "p_f32" else p.to(v.dtype).to(torch.float32)
        pv = torch.einsum("bkgqc,bkcd->bkgqd", pr, vt[:, :, k0:k1].to(torch.float32))
        keep = 1.0 if fault == "no_rescale" and t == bad_tile else corr[..., None]
        acc[..., r0:, :] = acc[..., r0:, :] * keep + pv
        m[..., r0:] = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3).contiguous().to(q.dtype)


def faults_for(dtype, causal, Sq, Sk) -> list:
    """The planted faults that change something at this case."""
    import torch

    out = []
    for f in FAULTS:
        if f == "p_f32" and dtype == torch.float32:
            continue  # p is already f32
        if f == "mask_one_ahead" and not causal:
            continue
        if f == "bottom_right" and (not causal or Sq == Sk):
            continue
        out.append(f)
    return out


def reading(out, plain) -> dict:
    """``mismatch`` plus the histogram of per-element differences in ulps of
    |plain| and the largest excess over 2 ulps (what an absolute term would
    have to cover)."""
    from repro_torch.kernels import flash_attention as kfa

    r = kfa.mismatch(out, plain)
    o, p = out.float(), plain.float()
    d = (o - p).abs()
    u = kfa.ulp(p, plain.dtype)
    ratio = d / u
    hist = {}
    for lo, hi in zip(ULP_BINS[:-1], ULP_BINS[1:]):
        sel = (ratio > lo) & (ratio <= hi)
        hist[f"({lo:g},{hi:g}]"] = int(sel.sum())
    r["ulp_histogram"] = hist
    r["max_excess_over_2ulp"] = float((d - 2.0 * u).max())
    r["mean_abs_plain"] = float(p.abs().mean())
    r["n"] = d.numel()
    return r


def exact_attention(q, k, v, causal):
    """The attention in f64 (an exact reference for f32 inputs), four heads
    at a time."""
    import torch

    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    keep = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)[None, :]
    for h0 in range(0, H, 4):
        kd = k.double().repeat_interleave(G, 2)[:, :, h0:h0 + 4]
        vd = v.double().repeat_interleave(G, 2)[:, :, h0:h0 + 4]
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, :, h0:h0 + 4].double(), kd) * D**-0.5
        if causal:
            s = s.masked_fill(~keep, -1e30)
        out[:, :, h0:h0 + 4] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    return out


def f32_candidates(q, k, v, causal) -> dict:
    """The planted faults of tensor-core f32 and the two readings of the rule."""
    cand = {f: split3_attention(q, k, v, causal=causal, **kw)
            for f, kw in F32_FAULTS.items()}
    cand["qk_tensor_cores"] = split3_attention(
        q, k, v, causal=causal, qk_pairs=SPLIT3_PAIRS)
    cand["exact"] = exact_attention(q, k, v, causal)
    return cand


def kernel_readings(dev) -> list:
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_attention as kfa

    gen = torch.Generator(device=dev)
    gen.manual_seed(777)  # the kernels phase's seed and order
    rows = []
    for case in chip_smoke.FLASH_CASES:
        label, B, Sq, Sk, H, KV, D, causal, dt = case
        dtype = getattr(torch, dt)
        q, k, v = chip_smoke._flash_inputs(case, gen, dev)
        plain = kfa.flash_attention_plain(q, k, v, causal=causal)
        cand = {"kernel": kfa.flash_mha(q, k, v, causal=causal)}
        for f in faults_for(dtype, causal, Sq, Sk):
            cand[f] = plain_with_fault(q, k, v, f, causal)
        if dtype == torch.float32:
            cand.update(f32_candidates(q, k, v, causal))
        for name, out in cand.items():
            r = dict(case=label, dtype=dt, causal=causal, Sq=Sq, Sk=Sk, D=D, variant=name,
                     design=kfa.kernel_design(dtype, D) if name == "kernel" else None,
                     **reading(out, plain))
            print(json.dumps(r), flush=True)
            rows.append(r)
        del q, k, v, plain, cand
        torch.cuda.empty_cache()
    return rows


def serve_readings(dev) -> list:
    import torch

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers
    from repro_torch.models.registry import build_model

    cfg = get_arch("qwen3-8b").with_(use_flash_kernel=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)  # the serve phase's weights and prompts
    params = build_model(cfg).init(gen, dev)
    kw = dict(batch=chip_smoke.SERVE_BATCH, prompt_len=chip_smoke.SERVE_PROMPT, gen=1,
              seed=0, device=dev, params=params)
    chunked = serve(cfg.with_(use_flash_kernel=False), **kw).prefill_logits
    lc = torch.log_softmax(chunked, -1)
    top1 = chunked.argmax(-1)
    variants = {"kernel": kfa.flash_mha, "plain": kfa.flash_attention_plain}
    for f in faults_for(torch.bfloat16, True, 1, 1):
        variants[f] = (lambda f: lambda q, k, v, causal=True: plain_with_fault(q, k, v, f,
                                                                               causal))(f)
    rows = []
    real = layers.flash_mha
    try:
        for name, fn in variants.items():
            layers.flash_mha = fn
            logits = serve(cfg, **kw).prefill_logits
            d = (torch.log_softmax(logits, -1) - lc).abs().max()
            r = {"serve_variant": name, "max_dlogsoftmax": float(d),
                 "top1_agree": (logits.argmax(-1) == top1).tolist(),
                 "finite": bool(torch.isfinite(logits).all())}
            print(json.dumps(r), flush=True)
            rows.append(r)
    finally:
        layers.flash_mha = real
    return rows


def plain_rounding_library():
    """``csrc/flash_attention.cu`` with ``PLAIN_ROUNDING`` applied, built
    under ``build/flash_probe/`` and loaded; its launcher."""
    import ctypes

    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in PLAIN_ROUNDING:
        if src.count(old) != 1:
            sys.exit(f"the source no longer has one {old!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / "flash_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_plain_rounding.cu").write_text(src)
    lib = out / "libflash_plain_rounding.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "flash_plain_rounding.cu")], check=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).flash_attention_launch
    fn.argtypes = _build.SIGNATURES["flash_attention"]["flash_attention_launch"]
    fn.restype = ctypes.c_int
    return fn


def launch_with(fn, q, k, v, causal):
    """bf16 q, k, v (a width of HEAD_DIMS) through the launcher ``fn``, as
    ``flash_mha`` launches them."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa

    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    _build.launch(fn, q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, H, KV, D, kfa._DTYPE_CODE[q.dtype], int(causal), D**-0.5)
    return out


def small_readings(dev, n_seeds: int = SMALL_SEEDS) -> dict:
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_attention as kfa

    plain_rounding = plain_rounding_library()
    rows = []
    for B, Sq, Sk, H, KV, causal in SMALL_CASES:
        for D in kfa.HEAD_DIMS:
            test_seed = B * 7 + Sq + Sk + D + H // KV  # the card test's draw
            n = B * Sq * H * D
            counts = {name: [] for name in ("kernel", "plain_rounding", *SMALL_FAULTS)}
            for seed in (*range(n_seeds), test_seed):
                gen = torch.Generator(device=dev).manual_seed(seed)
                q = torch.randn((B, Sq, H, D), generator=gen, device=dev).bfloat16()
                k = torch.randn((B, Sk, KV, D), generator=gen, device=dev).bfloat16()
                v = torch.randn((B, Sk, KV, D), generator=gen, device=dev).bfloat16()
                plain = kfa.flash_attention_plain(q, k, v, causal=causal)
                outs = {"kernel": kfa.flash_mha(q, k, v, causal=causal),
                        "plain_rounding": launch_with(plain_rounding, q, k, v, causal)}
                for f in SMALL_FAULTS:
                    outs[f] = plain_with_fault(q, k, v, f, causal)
                for name, out in outs.items():
                    counts[name].append(int((out.float() != plain.float()).sum()))
            # what mismatch allows to differ: the share, or the floor TOL_N0
            allowed = max(kfa.TOL_SHARE[torch.bfloat16] * n, kfa.small_floor(torch.bfloat16, D))
            r = {"small_case": f"B {B}, Sq {Sq}, Sk {Sk}, H {H}, KV {KV}, causal {causal}",
                 "D": D, "n": n, "seeds": n_seeds, "test_seed": test_seed}
            for name, c in counts.items():
                seeds = c[:-1]
                r[name] = {"max": max(seeds), "min": min(seeds), "test_draw": c[-1],
                           "seeds_changed": sum(x > 0 for x in seeds),
                           "min_changed": min((x for x in seeds if x > 0), default=0),
                           "seeds_over_share": sum(x > kfa.TOL_SHARE[torch.bfloat16] * n
                                                   for x in seeds),
                           "test_draw_over_share": c[-1] > kfa.TOL_SHARE[torch.bfloat16] * n,
                           "seeds_over_rule": sum(x > allowed for x in seeds),
                           "test_draw_over_rule": c[-1] > allowed}
            print(json.dumps(r), flush=True)
            rows.append(r)
    max_a = max(r["kernel"]["max"] for r in rows)
    faults = [r[f]["min_changed"] for r in rows for f in SMALL_FAULTS if r[f]["seeds_changed"]]
    summary = {
        "kernel_max_differing": max_a,
        "kernel_seeds_over_share": sum(r["kernel"]["seeds_over_share"] for r in rows),
        "kernel_seeds_over_rule": sum(r["kernel"]["seeds_over_rule"] for r in rows),
        "faults_seeds_within_rule": sum(r[f]["seeds_changed"] - r[f]["seeds_over_rule"]
                                        for r in rows for f in SMALL_FAULTS),
        "plain_rounding_max_differing": max(r["plain_rounding"]["max"] for r in rows),
        "plain_rounding_seeds_over_share": sum(r["plain_rounding"]["seeds_over_share"]
                                               for r in rows),
        "plain_rounding_test_draws_over_share": sum(r["plain_rounding"]["test_draw_over_share"]
                                                    for r in rows),
        "faults_min_differing": min(faults),
        "faults_changing_nothing": [(r["small_case"], r["D"], f) for r in rows
                                    for f in SMALL_FAULTS if r[f]["seeds_changed"] < n_seeds],
        # per head width: the sound kernel's largest count, the faults'
        # smallest where they change anything, and the floor TOL_N0 gives
        "per_d": {D: {"kernel_max": max(r["kernel"]["max"] for r in rows if r["D"] == D),
                      "faults_min": min((r[f]["min_changed"] for r in rows if r["D"] == D
                                         for f in SMALL_FAULTS if r[f]["seeds_changed"]),
                                        default=None),
                      "floor": kfa.small_floor(torch.bfloat16, D)}
                  for D in kfa.HEAD_DIMS},
    }
    # (b)'s cost at the serve layer, queued, in turns
    case = chip_smoke.FLASH_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(777)
    q, k, v = chip_smoke._flash_inputs(case, gen, dev)
    causal = case[7]
    times = {"kernel": [], "plain_rounding": []}
    for name in ("kernel", "plain_rounding", "plain_rounding", "kernel"):
        fn = ((lambda: kfa.flash_mha(q, k, v, causal=causal)) if name == "kernel" else
              (lambda: launch_with(plain_rounding, q, k, v, causal)))
        times[name].append(chip_smoke.cuda_ms_queued(fn))
    summary["serve_layer_queued_ms"] = times
    summary["plain_rounding_cost"] = min(times["plain_rounding"]) / min(times["kernel"]) - 1
    print(json.dumps(summary), flush=True)
    return {"rows": rows, "summary": summary}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_probe.json"))
    ap.add_argument("--parts", default="kernel,serve,small")
    ap.add_argument("--small-seeds", type=int, default=SMALL_SEEDS,
                    help="random draws a case and width in part 3")
    args = ap.parse_args()
    parts = args.parts.split(",")

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: the probe needs one card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = {}
    for name, fn in (("kernel", kernel_readings), ("serve", serve_readings),
                     ("small", lambda d: small_readings(d, args.small_seeds))):
        if name in parts:
            res[name] = fn(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0]
    res["torch"] = torch.__version__
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"{res['card']}; probe done in {time.perf_counter() - t0:.1f} s -> {out}")


if __name__ == "__main__":
    main()
