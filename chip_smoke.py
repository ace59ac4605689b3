#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each fatal on failure (exit 1, no result line):

1. probe   — a CUDA device is required; prints the card's name and power
             limit as ``nvidia-smi`` reports them.
2. build   — builds every kernel of ``tensorflowdistributedlearning_tpu_torch/
             csrc`` with nvcc (in parallel) and prints the build seconds.
3. kernels — runs one forward of the full-width serve model (ModelConfig()
             with use_pallas_depthwise=True, seeded random weights and BN
             statistics) at bucket 64, captures every kernel call's inputs,
             and holds each kernel against its plain PyTorch version on those
             inputs and on extra sweeps. Tolerances: sigmoid-mask bitwise;
             fused BN+act rtol 1e-6, atol 1e-6 (sigmoid/gelu are libm calls
             that may differ by an ulp); depthwise atol 1e-5 (summation order
             differs from the grouped conv). TF32 is off for convs and
             matmuls. Times are medians of CUDA-event timings with the 50 MB
             L2 flushed before every launch; per kernel they are summed over
             the calls of one forward at bucket 64, beside the bound (bytes
             over 3.35 TB/s or f32 operations over 67 TFLOP/s, the larger).
4. serve   — exports an artifact, serves it through the port's engine,
             micro-batcher and HTTP server on an ephemeral port, sends
             concurrent /v1/predict requests of 1-16 instances plus timed
             requests per bucket, expects 413 above 64 instances, checks
             shapes, mask == (probs > 0.5) and agreement with a forward
             through the plain versions on the card (probs atol 1e-5; mask
             equal where |p - 0.5| >= 1e-5), and checks that the served
             forwards launched 3 depthwise, 59 BN+act and 1 sigmoid-mask
             kernels each.

Prints the kernel table as one JSON line, then the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

SEED = 20261016
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_S = 67e12  # H100 SXM f32 outside the tensor cores
BUCKET = 64
TOL_DEPTHWISE = 1e-5
TOL_BN = 1e-6
TOL_PROBS = 1e-5
PKG = "tensorflowdistributedlearning_tpu_torch"
REPLACES = {
    "depthwise_conv2d": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:138",
    "fused_bn_act": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:398",
    "fused_sigmoid_mask": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:573",
}
SOURCES = {
    "depthwise_conv2d": f"{PKG}/csrc/depthwise.cu",
    "fused_bn_act": f"{PKG}/csrc/bn_act.cu",
    "fused_sigmoid_mask": f"{PKG}/csrc/sigmoid_mask.cu",
}
PER_FORWARD = {"depthwise_conv2d": 3, "fused_bn_act": 59, "fused_sigmoid_mask": 1}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing -----------------------------------------------------------------


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        for s, e in zip(starts, ends):
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S) * 1e3


def bound_by(nbytes: float, flops: float) -> str:
    return "bytes" if nbytes / PEAK_BYTES_S >= flops / PEAK_F32_FLOP_S else "operations"


def depthwise_valid_taps(h: int, w: int, k: int, rate: int) -> int:
    """Taps inside the image summed over output pixels (SAME, stride 1)."""
    pad = rate * (k - 1) // 2

    def per_axis(n):
        return sum(1 for o in range(n) for i in range(k) if 0 <= o + i * rate - pad < n)

    return per_axis(h) * per_axis(w)


# -- phases -------------------------------------------------------------------


def probe(torch) -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    return card


def build():
    from tensorflowdistributedlearning_tpu_torch.ops import _build, kernels

    t0 = time.perf_counter()
    paths = _build.build_all()
    built = time.perf_counter() - t0
    for name in paths:
        kernels._entry(name)
    log(f"build: {len(paths)} kernel libraries, nvcc in parallel {built:.3f} s, "
        f"loaded in {time.perf_counter() - t0:.3f} s")


def randomize_bn(torch, model, generator) -> None:
    """Random BN parameters and running statistics, so BN is no identity."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.bias.shape[0]
                m.weight.copy_(torch.empty(c).uniform_(0.8, 1.2, generator=generator))
                m.bias.copy_(torch.empty(c).normal_(0.0, 0.1, generator=generator))
                m.running_mean.copy_(torch.empty(c).normal_(0.0, 0.1, generator=generator))
                m.running_var.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=generator))


def make_instances(torch, n: int, seed: int):
    """Seeded 101x101 grey images through normalize + add_laplace_channel."""
    from tensorflowdistributedlearning_tpu_torch.data.augment import add_laplace_channel, normalize

    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 101, 101, 1)).astype(np.float32))
    return add_laplace_channel(normalize(images)).numpy()


def capture_path_calls(torch, model, x):
    """One forward with hooks recording each kernel call's inputs."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, DepthwiseConv2D

    calls = {"bn": [], "dw": []}

    def bn_hook(module, args, kwargs):
        inp = args[0].contiguous()
        m, b = module.folded()
        calls["bn"].append((inp, m, b, kwargs.get("act", "relu"), kwargs.get("residual")))

    def dw_hook(module, args):
        calls["dw"].append((args[0].contiguous(), module.weight.detach(), module.rate))

    handles = []
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            handles.append(mod.register_forward_pre_hook(bn_hook, with_kwargs=True))
        elif isinstance(mod, DepthwiseConv2D):
            handles.append(mod.register_forward_pre_hook(dw_hook))
    try:
        with torch.inference_mode():
            logits = model(x)
    finally:
        for h in handles:
            h.remove()
    return calls, logits


def kernel_phase(torch, model, timer):
    import torch.nn.functional as F

    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    x = torch.from_numpy(make_instances(torch, BUCKET, SEED)).cuda()
    calls, logits = capture_path_calls(torch, model, x)
    check(len(calls["dw"]) == PER_FORWARD["depthwise_conv2d"], f"depthwise calls per forward: {len(calls['dw'])}")
    check(len(calls["bn"]) == PER_FORWARD["fused_bn_act"], f"BN+act calls per forward: {len(calls['bn'])}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}

    # depthwise: the path's three ASPP calls, plus one odd shape
    err = 0.0
    ms = plain = lib = nbytes = flops = 0.0
    with torch.inference_mode():
        for xin, w, rate in calls["dw"]:
            got = kernels.depthwise_conv2d(xin, w, rate)
            want = kernels.depthwise_conv2d_plain(xin, w, rate)
            e = (got - want).abs().max().item()
            check(e <= TOL_DEPTHWISE, f"depthwise rate {rate} {tuple(xin.shape)}: max|err| {e} > {TOL_DEPTHWISE}")
            err = max(err, e)
            b, h, wd, c = xin.shape
            k = w.shape[0]
            ms += timer.ms(lambda: kernels.depthwise_conv2d(xin, w, rate))
            plain += timer.ms(lambda: kernels.depthwise_conv2d_plain(xin, w, rate))
            xv = xin.permute(0, 3, 1, 2)
            wt = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            pad = rate * (k - 1) // 2
            lib += timer.ms(lambda: F.conv2d(xv, wt, padding=pad, dilation=rate, groups=c))
            nbytes += 4 * (2 * xin.numel() + w.numel())
            flops += 2 * b * c * depthwise_valid_taps(h, wd, k, rate)
            log(f"depthwise {tuple(xin.shape)} rate {rate}: max|err| {e:.3g}")
        xo = torch.randn(5, 17, 23, 72, device="cuda", generator=gen)
        wo = torch.randn(5, 5, 72, device="cuda", generator=gen)
        e = (kernels.depthwise_conv2d(xo, wo, 3) - kernels.depthwise_conv2d_plain(xo, wo, 3)).abs().max().item()
        check(e <= TOL_DEPTHWISE, f"depthwise odd shape: max|err| {e}")
        err = max(err, e)
    rows["depthwise_conv2d"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                    bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))

    # BN + act: the path's 59 calls, then every act with and without a residual
    err = 0.0
    ms = plain = nbytes = flops = 0.0
    with torch.inference_mode():
        for xin, m, b, act, res in calls["bn"]:
            got = kernels.bn_act_folded(xin, m, b, act, res)
            want = kernels.bn_act_folded_plain(xin, m, b, act, res)
            torch.testing.assert_close(got, want, rtol=TOL_BN, atol=TOL_BN)
            err = max(err, (got - want).abs().max().item())
            ms += timer.ms(lambda: kernels.bn_act_folded(xin, m, b, act, res))
            plain += timer.ms(lambda: kernels.bn_act_folded_plain(xin, m, b, act, res))
            nbytes += 4 * (2 * xin.numel() + 2 * m.numel() + (res.numel() if res is not None else 0))
            flops += 3 * xin.numel()
        shapes = sorted({tuple(c[0].shape) for c in calls["bn"]}, key=lambda s: -np.prod(s))
        for shape in (shapes[0], shapes[-1], (3, 7, 5, 33)):
            c = shape[-1]
            xs = 3 * torch.randn(shape, device="cuda", generator=gen)
            rs = torch.randn(shape, device="cuda", generator=gen)
            vecs = (torch.rand(c, device="cuda", generator=gen) + 0.5,
                    torch.randn(c, device="cuda", generator=gen),
                    torch.randn(c, device="cuda", generator=gen),
                    torch.rand(c, device="cuda", generator=gen) + 0.5)
            for act in kernels.ACTIVATIONS:
                for res in (None, rs):
                    got = kernels.fused_bn_act(xs, *vecs, act=act, residual=res)
                    want = kernels.fused_bn_act_plain(xs, *vecs, act=act, residual=res)
                    torch.testing.assert_close(got, want, rtol=TOL_BN, atol=TOL_BN,
                                               msg=lambda m: f"bn_act {shape} {act} res={res is not None}: {m}")
                    err = max(err, (got - want).abs().max().item())
    log(f"fused_bn_act: {len(calls['bn'])} path calls + sweep, max|err| {err:.3g}")
    rows["fused_bn_act"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                                bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))

    # sigmoid-mask: the path's logits, then an edge sweep; bitwise
    def bitwise(lg, what):
        p, mk = kernels.fused_sigmoid_mask(lg, 0.5)
        pp, mp = kernels.fused_sigmoid_mask_plain(lg, 0.5)
        diff = (p.view(torch.int32) != pp.view(torch.int32)) | (mk.view(torch.int32) != mp.view(torch.int32))
        if bool(diff.any()):
            bad = diff.flatten().nonzero().flatten()[:5]
            raise SmokeFailure(f"sigmoid-mask not bitwise on {what}: {int(diff.sum())} elements differ, "
                               f"e.g. inputs {lg.flatten()[bad].tolist()} kernel {p.flatten()[bad].tolist()} "
                               f"plain {pp.flatten()[bad].tolist()}")
        finite = torch.isfinite(pp)
        return max((p - pp)[finite].abs().max().item() if bool(finite.any()) else 0.0, (mk - mp).abs().max().item())

    with torch.inference_mode():
        err = bitwise(logits, f"path logits {tuple(logits.shape)}")
        edges = torch.tensor(
            [float("inf"), float("-inf"), 0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 1e-8, -1e-8, 6e-8, -6e-8,
             1e-7, -1e-7, 88.0, -88.0, 88.7, -88.7, 89.0, -89.0, 103.9, -103.9, 104.0, -104.0, 1e4, -1e4,
             3.4e38, -3.4e38, 17.0, -17.0, 16.6, -16.6],
            device="cuda",
        )
        err = max(err, bitwise(edges, "edge values"))
        err = max(err, bitwise(torch.linspace(-110.0, 110.0, 1 << 22, device="cuda"), "linspace sweep"))
        err = max(err, bitwise(torch.linspace(-1e-3, 1e-3, 1 << 20, device="cuda"), "near-zero sweep"))
        bits = torch.randint(-(2 ** 31), 2 ** 31 - 1, (1 << 22,), device="cuda", generator=gen, dtype=torch.int64)
        rnd = bits.to(torch.int32).view(torch.float32)
        err = max(err, bitwise(rnd[torch.isfinite(rnd)], "random finite bit patterns"))
        n = logits.numel()
        ms = timer.ms(lambda: kernels.fused_sigmoid_mask(logits, 0.5))
        plain = timer.ms(lambda: kernels.fused_sigmoid_mask_plain(logits, 0.5))
        nbytes, flops = 4 * 3 * n, 4 * n
    log("fused_sigmoid_mask: bitwise equal on path logits and edge sweeps")
    rows["fused_sigmoid_mask"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                                      bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))
    return rows


def profile_forward(torch, engine, x, reps: int = 3):
    """torch.profiler over ``reps`` engine forwards at bucket 64: wall time,
    summed device-kernel time and the idle share per forward, and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    engine.infer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.infer(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels_us = {}
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels_us[evt.name] = kernels_us.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    device_ms = sum(kernels_us.values()) / 1e3 / reps
    if device_ms <= 0:
        return [f"bucket {x.shape[0]}: wall {wall_ms:.3f} ms per forward; device time not measured "
                "(the profiler recorded no CUDA kernels)"]
    lines = [f"bucket {x.shape[0]}: wall {wall_ms:.3f} ms per forward, device kernels {device_ms:.3f} ms, "
             f"device idle {max(0.0, 1 - device_ms / wall_ms):.3f} of the wall time"]
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]:
        lines.append(f"  {us / 1e3 / reps:9.3f} ms  {name[:110]}")
    return lines


def post(url: str, payload: dict, timeout: float = 300.0):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_phase(torch, model, cfg, card: str, device: str = "cuda"):
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, ServingServer, bind_ephemeral,
    )
    from tensorflowdistributedlearning_tpu_torch.train import serving

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as art:
        serving.export_serving_artifact(model, cfg, art)
        engine = InferenceEngine.from_artifact(art, device=device)
        warm = engine.warmup()
        log(f"serve: warmup s per bucket {json.dumps({str(b): round(s, 4) for b, s in warm.items()})}")
        batcher = MicroBatcher(engine, max_wait_ms=5.0, max_queue=256)
        server = ServingServer(engine, batcher, sock=bind_ephemeral("127.0.0.1", 0)).start()
        url = server.url + "/v1/predict"
        try:
            # the main path: counts from 0 just before, read just after
            kernels.reset_launch_counts()
            sizes = [1, 3, 16, 7, 2, 12, 4, 16, 1, 5, 9, 1]
            inst = {i: make_instances(torch, n, SEED + 1 + i) for i, n in enumerate(sizes)}

            def one(i):
                return i, post(url, {"instances": inst[i].tolist()})

            # record the batches the engine runs (padded input, outputs) for
            # the concurrent requests, to hold them against the plain forward
            batches = []
            serve_fn = engine.serve_fn

            def recording(x):
                out = serve_fn(x)
                batches.append((np.array(x, copy=True), {k: v.cpu().numpy() for k, v in out.items()}))
                return out

            engine.serve_fn = recording
            with ThreadPoolExecutor(max_workers=6) as pool:
                answered = dict(pool.map(one, range(len(sizes))))
            engine.serve_fn = serve_fn
            per_bucket = {}
            for b in engine.buckets:
                x = make_instances(torch, b, SEED + 100 + b).tolist()
                lat = []
                for _ in range(3 if b == 64 else 5):
                    t0 = time.perf_counter()
                    status, _ = post(url, {"instances": x})
                    lat.append(time.perf_counter() - t0)
                    check(status == 200, f"bucket {b} request: HTTP {status}")
                per_bucket[b] = statistics.median(lat) * 1e3
            one_x = make_instances(torch, 1, SEED + 7).tolist()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                statuses = list(pool.map(lambda _: post(url, {"instances": one_x})[0], range(96)))
            rps = len(statuses) / (time.perf_counter() - t0)
            check(all(s == 200 for s in statuses), f"closed-loop statuses {sorted(set(statuses))}")
            # the engine alone (no HTTP/JSON): forward latency per bucket, and
            # a profiler view of one bucket-64 forward
            engine_ms = {}
            for b in engine.buckets:
                x = make_instances(torch, b, SEED + 200 + b)
                lat = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    engine.infer(x)
                    lat.append(time.perf_counter() - t0)
                engine_ms[b] = statistics.median(lat) * 1e3
            profile = profile_forward(torch, engine, make_instances(torch, BUCKET, SEED + 300))
            counts = kernels.launch_counts()
            forwards = sum(engine.bucket_hits.values())

            status, body = post(url, {"instances": make_instances(torch, 65, SEED + 9).tolist()})
            check(status == 413 and body["error"]["code"] == "request_too_large", f"65 instances: HTTP {status} {body}")
            with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
                check(json.loads(r.read())["ok"] is True, "healthz not ok")
        finally:
            server.shutdown()

        log(f"serve: {forwards} forwards, bucket hits {engine.bucket_hits}, launches {counts}")
        for b, ms in per_bucket.items():
            log(f"serve: bucket {b} p50 request latency {ms:.3f} ms over HTTP [{card}]")
        log(f"serve: {rps:.3f} requests/s, 8 closed-loop clients, 1 instance each [{card}]")
        for b, ms in engine_ms.items():
            log(f"engine: bucket {b} p50 forward {ms:.3f} ms (pad, H2D, forward, D2H; no HTTP) [{card}]")
        for line in profile:
            log(f"profile: {line} [{card}]")

        # each response is its rows of one engine batch, bit for bit; each
        # batch agrees with the same padded batch through the plain versions
        ref_model = serving.load_model(art, device)
        plain = {
            "depthwise_conv2d": kernels.depthwise_conv2d_plain,
            "bn_act_folded": kernels.bn_act_folded_plain,
            "fused_sigmoid_mask": kernels.fused_sigmoid_mask_plain,
        }
        for i, (status, body) in answered.items():
            n = sizes[i]
            check(status == 200, f"request {i}: HTTP {status} {body}")
            check(body["n"] == n, f"request {i}: n {body['n']} != {n}")
            p = np.asarray(body["predictions"]["probabilities"], np.float32)
            mk = np.asarray(body["predictions"]["mask"], np.float32)
            check(p.shape == (n, 101, 101, 1) and mk.shape == p.shape, f"request {i}: shapes {p.shape} {mk.shape}")
            check(bool(np.isfinite(p).all()), f"request {i}: non-finite probabilities")
            check(np.array_equal(mk, (p > 0.5).astype(np.float32)), f"request {i}: mask != (probs > 0.5)")
            rows = [
                (bx, bout, off) for bx, bout in batches for off in range(bx.shape[0] - n + 1)
                if np.array_equal(bx[off:off + n], inst[i])
            ]
            check(len(rows) >= 1, f"request {i}: its instances are in no engine batch")
            _, bout, off = rows[0]
            check(np.array_equal(p, bout["probabilities"][off:off + n]) and np.array_equal(mk, bout["mask"][off:off + n]),
                  f"request {i}: response differs from its engine batch's rows")
        with mock.patch.multiple(kernels, **plain):
            ref_serve = serving.make_serving_fn(ref_model, device)
            before = kernels.launch_counts()
            worst = 0.0
            for bx, bout in batches:
                ref = {k: v.cpu().numpy() for k, v in ref_serve(bx).items()}
                d = float(np.abs(bout["probabilities"] - ref["probabilities"]).max())
                worst = max(worst, d)
                check(d <= TOL_PROBS, f"batch of {bx.shape[0]}: probs differ from the plain forward by {d} > {TOL_PROBS}")
                away = np.abs(ref["probabilities"] - 0.5) >= 1e-5
                check(np.array_equal(bout["mask"][away], ref["mask"][away]), f"batch of {bx.shape[0]}: mask differs")
            check(kernels.launch_counts() == before, "the plain reference forward launched a kernel")
        log(f"serve: {len(answered)} concurrent responses in {len(batches)} engine batches agree with the plain "
            f"forward, max|dprobs| {worst:.3g}")
        for name, per in PER_FORWARD.items():
            check(counts[name] > 0, f"{name} was not launched on the serve path")
            check(counts[name] == per * forwards,
                  f"{name}: {counts[name]} launches for {forwards} forwards, expected {per} each")
        results["launches"] = counts
    return results


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not importable: {e}", file=sys.stderr)
        return 1
    try:
        card = probe(torch)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
            from tensorflowdistributedlearning_tpu_torch.models import build_model
        except ImportError as e:
            raise SmokeFailure(f"the port package is not importable from {os.getcwd()}: {e}")
        build()
        cfg = ModelConfig(use_pallas_depthwise=True)
        gen = torch.Generator().manual_seed(SEED)
        t0 = time.perf_counter()
        model = build_model(cfg, "cpu", generator=gen)
        randomize_bn(torch, model, gen)
        model = model.cuda().eval()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"model: full-width ResNet-v2 + DeepLabV3+, {n_params} parameters, built in {time.perf_counter() - t0:.3f} s")
        timer = Timer(torch)
        rows = kernel_phase(torch, model, timer)
        for name, r in rows.items():
            log(f"{name}: {r['ms']:.4f} ms per forward at bucket {BUCKET} (plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}) [{card}]")
        served = serve_phase(torch, model, cfg, card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    table = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": served["launches"][name], **rows[name]}
        for name in SOURCES
    ]
    print(json.dumps({"kernels": table, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
