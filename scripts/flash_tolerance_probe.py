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
   version.
2. The serve phase's end-to-end check at full Qwen3-8B width: max
   |log_softmax(prefill) - log_softmax(chunked prefill)| over the last
   position's logits, and the top-1 agreement, for the kernel, the plain
   version and each planted fault in place of ``flash_mha``.
3. The share's resolution on a small output: one query row over 256 keys
   without the mask at 8 heads (``tests/test_torch_kernels_cuda.py``'s
   smallest non-trivial Hopper case, 8 D elements), at every bf16 width
   and SMALL_SEEDS seeds, and at the test's own draw (its seed, 265 + D):
   the count of elements that differ for each seed.
   One rounding flip of a p moves its row's output at every column, so
   the differing elements come in clusters, and at 8 D elements a cluster
   of three reads above TOL_SHARE.

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
SMALL_SEEDS = 50


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


def small_readings(dev) -> list:
    import torch

    from repro_torch.kernels import flash_attention as kfa

    rows = []
    for D in kfa.HEAD_DIMS:
        counts, over_share, within = [], 0, 0
        for seed in (*range(SMALL_SEEDS), 265 + D):
            gen = torch.Generator(device=dev).manual_seed(seed)
            q, k, v = (torch.randn((1, S, 8, D), generator=gen, device=dev).bfloat16()
                       for S in (1, 256, 256))
            out = kfa.flash_mha(q, k, v, causal=False)
            plain = kfa.flash_attention_plain(q, k, v, causal=False)
            mm = kfa.mismatch(out, plain)
            counts.append(int((out.float() != plain.float()).sum()))
            if seed < SMALL_SEEDS:
                over_share += mm["share_differing"] > kfa.TOL_SHARE[torch.bfloat16]
                within += mm["within"]
        r = {"small_case": "B 1, Sq 1, Sk 256, H 8, KV 8, non-causal", "D": D, "n": 8 * D,
             "design": kfa.kernel_design(torch.bfloat16, D), "seeds": SMALL_SEEDS,
             "differing_counts": counts[:-1], "seeds_over_share": over_share,
             "seeds_within": within, "test_draw_differing": counts[-1]}
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_probe.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: the probe needs one card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = {"kernel": kernel_readings(dev), "serve": serve_readings(dev),
           "small": small_readings(dev)}
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
