#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which fails the run on error:

1. build   — compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source, in
             parallel) and print the build seconds and ptxas report.
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
             quant_block 256), with the launch counters zeroed just before
             and read just after; every kernel must have launched. The
             round's packed rows are re-aggregated with the plain versions on
             the card and must match the kernel path exactly; the byte
             accounting must match the wire format; params must be finite.

Then one JSON line ``{"kernels": [...]}``, the card's name and power limit
(``nvidia-smi``), and last the device line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA card, or outside the repository, it exits non-zero and prints
no result. ``--phases build,kernels`` runs a prefix of the phases (no result
lines).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32, outside the tensor cores


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


def bound_ms(nbytes: float, flops: float) -> float:
    """Least time for the work: bytes over HBM rate vs f32 ops over peak."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def bound_by(nbytes: float, flops: float) -> str:
    return "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"


def tensor_bytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


# ---------------------------------------------------------------- phase 1


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s for {len(_build.sources())} sources -> {_build.build_dir()}")
    for name, rec in sorted(_build.BUILD_LOG.items()):
        print(f"  {name}.cu nvcc {rec['seconds']:.2f} s")
        for line in str(rec["log"]).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"    {line.strip()}")
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

    cfg = FLConfig(n_clients=20, clients_per_round=20, seed=0)
    srv = FLServer(cfg, device=dev)
    M = srv.layout.padded_size
    print(f"rounds: DeepSpeech2 {srv.layout.size} params, M={M}, K={cfg.clients_per_round}, "
          f"local_steps={cfg.local_steps}, local_batch={cfg.local_batch}")
    round_inputs = []
    kota.ota_superpose.launches = 0
    kota.ota_fold.launches = 0
    ktk.topk_cosine.launches = 0
    for rnd in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.enabled() as tracer:  # host-clock spans of the round stages
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
        spans = {k: round(v["total_us"] / 1e3, 3) for k, v in tracer.summary().items()}
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
    """Each kernel's time per round on the last round's own inputs."""
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
        "ota_superpose": dict(ms=cuda_ms(sup), plain_ms=cuda_ms(sup_plain),
                              bound_ms=bound_ms(b_sup, f_sup),
                              bound_by=bound_by(b_sup, f_sup), library_ms=None,
                              shape=f"{kinds[0]} K_g={first[0].shape[0]}"),
        "ota_fold": dict(ms=cuda_ms(folds) if rest else 0.0,
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
    qv = torch.from_numpy(embed_batch(profiles)).to(dev)
    k = min(32, n)
    nbytes = tensor_bytes(qv) + n * data.shape[1] * data.element_size() + 20 * k * 8
    flops = 2.0 * qv.shape[0] * n * data.shape[1]
    out["topk_cosine"] = dict(
        ms=cuda_ms(lambda: ktk.topk_cosine(qv, data, sc, n, k=k)),
        plain_ms=cuda_ms(lambda: ktk.topk_plain(qv, data, sc, n, k)),
        bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops),
        library_ms=None, shape=f"Q={qv.shape[0]} Np={data.shape[0]} n={n} k={k}",
    )
    for name, rec in out.items():
        print(f"  per-round timing {name}: " + json.dumps(rec))
    return out


# ---------------------------------------------------------------- main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernels,rounds")
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
    if "rounds" not in phases:
        print(f"partial run ({args.phases}) done in {time.perf_counter() - t_start:.1f} s")
        return
    srv, counts, round_inputs = phase_rounds(dev)
    timings = time_round_kernels(srv, round_inputs, dev)

    sources = {"ota_superpose": "src/repro_torch/csrc/ota_superpose.cu",
               "ota_fold": "src/repro_torch/csrc/ota_superpose.cu",
               "topk_cosine": "src/repro_torch/csrc/topk_cosine.cu"}
    replaces = {"ota_superpose": "src/repro/kernels/ota_fused.py:288",
                "ota_fold": "src/repro/kernels/ota_fused.py:334",
                "topk_cosine": "src/repro/kernels/topk_similarity.py:83"}
    kernels = []
    for name in ("ota_superpose", "ota_fold", "topk_cosine"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": counts[name],
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
