#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. device: needs CUDA; prints the card's name and power limit; TF32 off;
2. build: compiles the CUDA kernels of vqa_project_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving shapes (f32 and bf16);
4. full-width forward (VQA v2 widths, random weights from a seed): the
   port on the card against the same port on the CPU;
5. serving, the main path: InferenceServer behind its HTTP front-end
   answers 64 requests from 8 keep-alive clients; every answer is held
   against a direct forward, and both kernels must have launched;
6. timing: each kernel, its plain version and the library call where
   one exists, with CUDA events, beside the least time the card needs.

The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Without a CUDA device, or without the repository beside it, the script
fails before printing any result.
"""

from __future__ import annotations

import http.client
import json
import math
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.data import FeatureStore, tokenize
from vqa_project_tpu_torch.models import GraphVQAModel
from vqa_project_tpu_torch.ops import (_build, bbox_centres,
                                       masked_neighbourhood,
                                       polar_pseudo_coords)
from vqa_project_tpu_torch.ops.edge_aggregate import (
    fused_sel_aggregate_act, sel_aggregate_act_reference)
from vqa_project_tpu_torch.ops.gru import (gru_scan_reference,
                                           input_projection)
from vqa_project_tpu_torch.ops.gru_scan import gru_scan
from vqa_project_tpu_torch.serve import InferenceServer, make_http_server

SEED = 20261016
# VQA v2 widths (hid 1024, 8 kernels, 16 neighbours, K=36, 3001 answers,
# 300-d embeddings, 2048+4 region features, ~13k question words)
FULL = dict(vocab_size=13000, emb_dim=300, feat_dim=2052, hid_dim=1024,
            out_dim=3001, combined_dim=512, n_kernels=8,
            neighbourhood_size=16, n_obj=36, dropout=0.5, max_qlen=16)
SERVE_B = 16
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
GAUSS_FLOPS = 25   # per (edge, kernel): two exp, two divides, ~20 more
GATE_FLOPS = 20    # per (row, unit, step): two sigmoid, tanh, blend

SOURCES = {
    "edge_aggregate_fwd": ("vqa_project_tpu_torch/csrc/edge_aggregate.cu",
                           "vqa_project_tpu/ops/pallas/edge_aggregate.py:194"),
    "gru_scan_fwd": ("vqa_project_tpu_torch/csrc/gru_scan.cu",
                     "vqa_project_tpu/ops/pallas/gru_scan.py:54"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-12)
    return float((got - want).abs().max()) / scale


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------- inputs ----------------


def random_boxes(b: int, k: int, gen: torch.Generator) -> torch.Tensor:
    xy1 = torch.rand(b, k, 2, generator=gen) * 0.5
    wh = 0.05 + torch.rand(b, k, 2, generator=gen) * 0.45
    return torch.cat([xy1, xy1 + wh], dim=-1)


def edge_inputs(b, k, m, n, d, use_alpha, gen, dev):
    """Kernel A's inputs as the model makes them: sel from a top-m
    selection, pseudo from box centres, gparams from the init ranges."""
    alpha, mask = masked_neighbourhood(torch.randn(b, k, k, generator=gen),
                                       m)
    pseudo = polar_pseudo_coords(bbox_centres(random_boxes(b, k, gen)))
    proj = torch.randn(b, k, n * d, generator=gen)
    gparams = torch.stack([
        torch.rand(n, generator=gen),
        (torch.rand(n, generator=gen) * 2 - 1) * math.pi,
        torch.rand(n, generator=gen), torch.rand(n, generator=gen)])
    sel = alpha if use_alpha else mask
    return [t.contiguous().to(dev) for t in (sel, pseudo, proj, gparams)]


def gru_inputs(b, t, e, h, gen, dev):
    """Kernel B's inputs: xp from embeddings through W_ih, torch-default
    GRU weights, qlen spread over 1..T."""
    bound = 1.0 / math.sqrt(h)

    def u(*shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * bound

    emb = torch.randn(b, t, e, generator=gen)
    w_ih, w_hh, b_ih, b_hh = u(3 * h, e), u(3 * h, h), u(3 * h), u(3 * h)
    qlen = (torch.arange(b) % t + 1).to(torch.int32)
    xp = input_projection(emb, w_ih, b_ih, torch.float32)
    return ([x.contiguous().to(dev) for x in (xp, w_hh, b_hh, qlen)],
            (emb.to(dev), w_ih.to(dev), b_ih.to(dev)))


# ---------------- timing and bounds ----------------


def time_ms(fn, samples: int = 50, reps: int = 10) -> float:
    """Median over `samples` of the mean time of `reps` back-to-back
    calls, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops_s: float):
    """(ms, "bytes"|"operations"): the larger of the two least times."""
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_bytes, ops_s) * 1e3,
            "bytes" if t_bytes >= ops_s else "operations")


def edge_bound(sel, pseudo, proj, gparams):
    b, k, nd = proj.shape
    n = gparams.shape[1]
    nbytes = (sel.numel() * 4 + pseudo.numel() * 4 + gparams.numel() * 4
              + 2 * proj.numel() * proj.element_size())
    ops_s = (2 * b * k * k * nd / PEAK_FLOPS[proj.dtype]
             + GAUSS_FLOPS * b * k * k * n / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


def gru_bound(xp, w_hh, b_hh, qlen):
    t, b, h3 = xp.shape
    h = h3 // 3
    nbytes = (xp.numel() * 4 + w_hh.numel() * w_hh.element_size()
              + b_hh.numel() * 4 + qlen.numel() * 4 + b * h * 4)
    steps = int(qlen.clamp(max=t).sum())  # rows past qlen need no work
    ops_s = (2 * steps * h * h3 / PEAK_FLOPS[w_hh.dtype]
             + GATE_FLOPS * steps * h / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


# ---------------- phases ----------------


def check_kernels(dev, gen):
    """Phase 3: each kernel against its plain version on the card."""
    errs = {}
    # kernel A: conv1 (alpha, d=256), conv2 (mask, d=128) at the VQA
    # shapes, and the medical K=51, m=19
    for b, k, m, d, use_alpha, label in [
            (SERVE_B, 36, 16, 256, True, "vqa conv1"),
            (SERVE_B, 36, 16, 128, False, "vqa conv2"),
            (8, 51, 19, 256, True, "medical conv1"),
            (8, 51, 19, 128, False, "medical conv2")]:
        sel, pseudo, proj, gp = edge_inputs(b, k, m, 8, d, use_alpha, gen,
                                            dev)
        out = fused_sel_aggregate_act(sel, pseudo, proj, gp, relu=True)
        ref = sel_aggregate_act_reference(sel, pseudo, proj, gp, relu=True)
        torch.cuda.synchronize()
        e32 = norm_err(out, ref)
        proj16 = proj.to(torch.bfloat16)
        out16 = fused_sel_aggregate_act(sel, pseudo, proj16, gp, relu=True)
        ref16 = sel_aggregate_act_reference(
            sel, pseudo, proj16.float(), gp, relu=True).to(torch.bfloat16)
        torch.cuda.synchronize()
        e16 = norm_err(out16, ref16)
        print(f"kernel A {label} B={b} K={k} d={d}: normalized err f32 "
              f"{e32:.3e} (<= 1e-5), bf16 {e16:.3e} (<= 1e-2)", flush=True)
        require(out16.dtype == torch.bfloat16 and out.shape == ref.shape,
                "kernel A output dtype/shape")
        require(e32 <= 1e-5 and e16 <= 1e-2, f"kernel A {label} disagrees")
        if label == "vqa conv1":
            errs["edge_aggregate_fwd"] = float(
                (out16.float() - ref16.float()).abs().max())
    # kernel B: T=16, H=1024, B=16 and 256, qlen spread over 1..16
    for b in (SERVE_B, 256):
        (xp, w_hh, b_hh, qlen), _ = gru_inputs(b, 16, 300, 1024, gen, dev)
        h = gru_scan(xp, w_hh, b_hh, qlen)
        ref = gru_scan_reference(xp, w_hh, b_hh, qlen)
        w16 = w_hh.to(torch.bfloat16)
        h16 = gru_scan(xp, w16, b_hh, qlen)
        ref16 = gru_scan_reference(xp, w16, b_hh, qlen)
        torch.cuda.synchronize()
        e32 = float((h - ref).abs().max())
        e16 = float((h16 - ref16).abs().max())
        print(f"kernel B B={b} T=16 H=1024: max abs err f32 {e32:.3e} "
              f"(<= 1e-5), bf16 weights {e16:.3e} (<= 2e-3)", flush=True)
        require(e32 <= 1e-5 and e16 <= 2e-3, f"kernel B B={b} disagrees")
        if b == SERVE_B:
            errs["gru_scan_fwd"] = e16
    return errs


def random_batch(b, cfg, gen):
    q = torch.randint(1, cfg.vocab_size, (b, cfg.max_qlen), generator=gen)
    qlen = torch.randint(3, 15, (b,), generator=gen).to(torch.int32)
    feats = torch.randn(b, cfg.n_obj, cfg.feat_dim - 4, generator=gen)
    image = torch.cat([feats, random_boxes(b, cfg.n_obj, gen)], dim=-1)
    return q, image, qlen


def full_width_forward(dev, gen):
    """Phase 4: the port on the card against the port on the CPU."""
    cfg32 = ModelConfig(**FULL, compute_dtype="float32")
    cpu = GraphVQAModel(cfg32, device="cpu", seed=SEED)
    gpu = GraphVQAModel(cfg32, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    q, image, qlen = random_batch(SERVE_B, cfg32, gen)
    logits_c, adj_c, _ = cpu(q, image, qlen)
    a0, b0 = fused_sel_aggregate_act.launches, gru_scan.launches
    logits_g, adj_g, hmax_g = gpu(q.to(dev), image.to(dev), qlen.to(dev))
    torch.cuda.synchronize()
    da = fused_sel_aggregate_act.launches - a0
    db = gru_scan.launches - b0
    require(da == 2 and db == cfg32.max_qlen,
            f"launches per forward: A {da} (want 2), B {db} (want "
            f"{cfg32.max_qlen})")
    el, ea = norm_err(logits_g.cpu(), logits_c), norm_err(adj_g.cpu(), adj_c)
    same = bool((logits_g.argmax(-1).cpu() == logits_c.argmax(-1)).all())
    print(f"full width f32, card vs CPU: logits {el:.3e}, adjacency "
          f"{ea:.3e} (<= 1e-4), argmax identical {same}; launches per "
          f"forward A={da} B={db}", flush=True)
    require(tuple(logits_g.shape) == (SERVE_B, cfg32.out_dim)
            and tuple(hmax_g.shape) == (SERVE_B, cfg32.hid_dim),
            "output shapes")
    require(bool(torch.isfinite(logits_g).all()), "non-finite logits")
    require(el <= 1e-4 and ea <= 1e-4 and same, "f32 forward disagrees")

    cfg16 = ModelConfig(**FULL)  # the default: bf16 compute
    bf16 = GraphVQAModel(cfg16, device=dev, seed=SEED)
    bf16.load_state_dict(cpu.state_dict())
    logits_b, _, _ = bf16(q.to(dev), image.to(dev), qlen.to(dev))
    agree = float((logits_b.argmax(-1).cpu()
                   == logits_c.argmax(-1)).float().mean())
    print(f"full width bf16 on card vs f32 CPU: argmax agreement "
          f"{agree:.4f} (>= 0.5), logits {norm_err(logits_b.cpu(), logits_c):.3e}",
          flush=True)
    require(agree >= 0.5, "bf16 argmax agreement below 0.5")
    return bf16


class ServingData:
    """The duck-typed dataset InferenceServer reads: vocabularies and a
    FeatureStore of random images (ids "100".."163")."""

    def __init__(self, cfg: ModelConfig, n_images: int, seed: int):
        rng = np.random.default_rng(seed)
        self.q_wtoi = {f"w{i}": i for i in range(1, cfg.vocab_size)}
        self.a_itow = {i: f"answer{i}" for i in range(cfg.out_dim - 1)}
        self.n_answers = cfg.out_dim
        self.max_qlen, self.n_obj = cfg.max_qlen, cfg.n_obj
        self.feat_dim = cfg.feat_dim
        feats = rng.normal(size=(n_images, cfg.n_obj, cfg.feat_dim - 4))
        xy1 = rng.uniform(0, 0.5, size=(n_images, cfg.n_obj, 2))
        wh = rng.uniform(0.05, 0.5, size=(n_images, cfg.n_obj, 2))
        boxes = np.concatenate([xy1, xy1 + wh], -1)
        self.store = FeatureStore(
            feats.astype(np.float32), boxes.astype(np.float32),
            {str(100 + i): i for i in range(n_images)})


def serve(model, dev, n_clients=8, per_client=8):
    """Phase 5, the main path: HTTP -> InferenceServer -> forward."""
    ds = ServingData(model.cfg, 64, SEED)
    rng = np.random.default_rng(SEED + 1)
    jobs = []
    for i in range(n_clients * per_client):
        n_words = int(rng.integers(3, 14))
        words = [f"w{int(w)}" for w in rng.integers(1, model.cfg.vocab_size,
                                                   n_words)]
        jobs.append((" ".join(words) + " ?", str(100 + i % 64)))

    fused_sel_aggregate_act.launches = 0
    gru_scan.launches = 0
    srv = InferenceServer(model, ds, device=dev, batch_size=SERVE_B,
                          max_wait_ms=5.0)
    httpd = make_http_server(srv, port=0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    host, port = httpd.server_address[:2]
    answers, latencies, failures = {}, [], []
    lock = threading.Lock()

    def client(c):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        try:
            for i in range(c, len(jobs), n_clients):
                question, iid = jobs[i]
                t0 = time.perf_counter()
                conn.request("POST", "/predict", body=json.dumps(
                    {"question": question, "image_id": iid}))
                resp = conn.getresponse()
                body = json.loads(resp.read())
                with lock:
                    latencies.append(time.perf_counter() - t0)
                    if resp.status != 200:
                        failures.append((i, resp.status, body))
                    else:
                        answers[i] = body["answer"]
        except Exception as e:  # reported below; the phase then fails
            with lock:
                failures.append((c, "client", repr(e)))
        finally:
            conn.close()

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        require(not any(c.is_alive() for c in clients), "clients hung")
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    launches = {"edge_aggregate_fwd": fused_sel_aggregate_act.launches,
                "gru_scan_fwd": gru_scan.launches}
    require(not failures, f"failed requests: {failures[:3]}")
    require(len(answers) == len(jobs), "missing answers")
    lat = sorted(latencies)
    print(f"serving: {len(jobs)} requests from {n_clients} keep-alive "
          f"clients in {wall:.3f} s, {health['batches_served']} batches, "
          f"latency p50 {1e3 * lat[len(lat) // 2]:.2f} ms p99 "
          f"{1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.2f} ms, "
          f"warmup_s {srv.warmup_s:.3f}; launches {launches}", flush=True)
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")

    # every answer against a direct forward of the same padded shape
    t, k, fdim = ds.max_qlen, ds.n_obj, ds.feat_dim
    mismatches = 0
    for s in range(0, len(jobs), SERVE_B):
        chunk = jobs[s:s + SERVE_B]
        q = np.zeros((SERVE_B, t), np.int64)
        qlen = np.ones((SERVE_B,), np.int32)
        image = np.zeros((SERVE_B, k, fdim), np.float32)
        for i, (question, iid) in enumerate(chunk):
            words = tokenize(question)[:t]
            q[i, :len(words)] = [ds.q_wtoi.get(w, 0) for w in words]
            qlen[i] = max(1, len(words))
            row = ds.store.id_to_row[iid]
            image[i, :, :fdim - 4] = ds.store.features[row]
            image[i, :, fdim - 4:] = ds.store.boxes[row]
        with torch.inference_mode():
            logits, _, _ = model(torch.from_numpy(q).to(dev),
                                 torch.from_numpy(image).to(dev),
                                 torch.from_numpy(qlen).to(dev))
            logits[:, -1] = float("-inf")
            top1 = logits.argmax(-1).cpu().numpy()
        for i in range(len(chunk)):
            if answers[s + i] != ds.a_itow[int(top1[i])]:
                mismatches += 1
    print(f"serving answers equal to a direct forward: "
          f"{len(jobs) - mismatches}/{len(jobs)}", flush=True)
    require(mismatches == 0, "served answers differ from the forward")
    return launches


def profile_forward(forward, n: int = 10) -> None:
    """Device time per forward by kernel (torch.profiler, CUPTI) beside
    the wall time of the same forwards: the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for evt in prof.key_averages():
        # kernels only: an aten op's device time repeats its kernels'
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.self_device_time_total / n / 1e3, evt.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    print(f"profile of the bf16 forward at B={SERVE_B}: wall {wall_ms:.4f} ms "
          f"per forward (profiler on), device busy {busy:.4f} ms "
          f"({100 * busy / wall_ms:.1f}%); top device items (ms per "
          f"forward): " + json.dumps([[round(ms, 5), key[:80]]
                                      for ms, key in rows[:10]]),
          flush=True)


def measure(dev, gen, launches, errs, model):
    """Phase 6: kernel, plain version and library call, on CUDA events,
    and the whole bf16 forward that holds them."""
    entries, detail = [], []
    for b in (SERVE_B, 256):
        batch = [x.to(dev) for x in random_batch(b, model.cfg, gen)]

        def forward():
            with torch.inference_mode():
                model(*batch)

        forward_ms = time_ms(forward, samples=20, reps=5)
        if b == SERVE_B:
            profile_forward(forward)
        a_in = [edge_inputs(b, 36, 16, 8, d, use_alpha, gen, dev)
                for d, use_alpha in ((256, True), (128, False))]
        for x in a_in:
            x[2] = x[2].to(torch.bfloat16)

        def kernel_a():
            for sel, pseudo, proj, gp in a_in:
                fused_sel_aggregate_act(sel, pseudo, proj, gp, relu=True)

        def plain_a():
            for sel, pseudo, proj, gp in a_in:
                sel_aggregate_act_reference(sel, pseudo, proj, gp, relu=True)

        nbytes = sum(edge_bound(*x)[0] for x in a_in)
        ops_s = sum(edge_bound(*x)[1] for x in a_in)
        a = dict(ms=time_ms(kernel_a), plain_ms=time_ms(plain_a),
                 library_ms=None)
        a["bound_ms"], a["bound_by"] = bound(nbytes, ops_s)
        per_conv = [time_ms(lambda x=x: fused_sel_aggregate_act(
            *x, relu=True)) for x in a_in]

        (xp, w_hh, b_hh, qlen), (emb, w_ih, b_ih) = gru_inputs(
            b, 16, 300, 1024, gen, dev)
        w16 = w_hh.to(torch.bfloat16)
        gru = torch.nn.GRU(300, 1024, batch_first=True, device=dev,
                           dtype=torch.bfloat16)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(w_ih)
            gru.weight_hh_l0.copy_(w_hh)
            gru.bias_ih_l0.copy_(b_ih)
            gru.bias_hh_l0.copy_(b_hh)
        gru.flatten_parameters()
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            emb.to(torch.bfloat16), qlen.cpu().long(), batch_first=True,
            enforce_sorted=False)

        def library_b():
            with torch.no_grad():
                gru(packed)

        g = dict(ms=time_ms(lambda: gru_scan(xp, w16, b_hh, qlen)),
                 plain_ms=time_ms(
                     lambda: gru_scan_reference(xp, w16, b_hh, qlen)),
                 library_ms=time_ms(library_b))
        g["bound_ms"], g["bound_by"] = bound(*gru_bound(xp, w16, b_hh, qlen))
        g_f32 = time_ms(lambda: gru_scan(xp, w_hh, b_hh, qlen))
        detail.append({"batch": b, "forward_ms": forward_ms,
                       "edge_aggregate_fwd": a,
                       "edge_aggregate_fwd_per_conv_ms": per_conv,
                       "gru_scan_fwd": g, "gru_scan_fwd_f32_weights_ms":
                       g_f32})
        if b == SERVE_B:
            for name, t in (("edge_aggregate_fwd", a), ("gru_scan_fwd", g)):
                src, rep = SOURCES[name]
                entries.append({
                    "name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"]})
    print("timing detail (bf16 forward; bf16 proj / bf16 W_hh; A = conv1 + "
          "conv2 launches; B = all 16 step launches): " + json.dumps(detail),
          flush=True)
    return entries


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase("2 build")
    print(f"built {', '.join(_build.KERNELS)} in {_build.build_all():.2f} s "
          f"into {_build.build_dir()}", flush=True)
    for name in _build.KERNELS:
        print(f"{name}.cu ptxas:\n{_build.resource_report(name)}", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    phase("3 kernels against their plain versions")
    errs = check_kernels(dev, gen)
    phase("4 full-width forward")
    model = full_width_forward(dev, gen)
    phase("5 serving (main path)")
    launches = serve(model, dev)
    phase("6 timing")
    entries = measure(dev, gen, launches, errs, model)

    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
