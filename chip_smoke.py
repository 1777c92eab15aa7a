#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--scratch DIR] [--trace DIR]

Run from a checkout of the repository on a machine with an NVIDIA H100 (the
kernels are built for ``sm_90a``) and the CUDA toolkit.  It imports the port
only: neither ``jax`` nor the JAX package.  Phases, each of which raises on
any failure (the script then exits non-zero):

  1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
     versions;
  2. the build of every kernel from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, in parallel), with its time;
  3. the main path: the full veloc-demo-100m train state (AdamW, f32, about
     1 GB) built on the card from a seeded generator and split over the 4
     ranks of one XOR group; the default ``VelocConfig(mode="async")``;
     checkpoint v1, an in-place update, checkpoint v2, drain; every rank's
     ``restart_latest`` returns v2 equal to the live state; then node loss
     (nodes 2 and 3 fail, rank 2's L3 shard is deleted) and rank 2 is
     rebuilt from XOR parity, equal again.  Each checkpoint call prints its
     blocking time beside the calling thread's CPU time and the allocator's
     new device segments (``cudaMalloc`` calls) in that call;
  4. each kernel against its plain PyTorch version on the card, bit-exact,
     at small shapes and at the exact shapes the main path gave it (one
     shard's checksum rows; the XOR group's words in the aligned row layout
     of ``ops.xor_reduce``), with the kernel's median time from CUDA events,
     its bound (bytes / 3.35 TB/s) and the plain version's time; and the
     host-to-device copy of a shard-sized buffer next to the checksum kernel
     that digests it;
  5. a ``{"kernels": [...]}`` line: each kernel's launches on the main path
     (counts set to 0 just before it), times, bound and error;
  6. as the last line, ``{"ok": true, "device": {...}}``.

``--trace DIR`` also records the checkpoint calls and the drain with
``torch.profiler`` (``DIR/trace.json.gz``) and runs a probe thread that
measures how long the interpreter lock is held away from it;
``DIR/blocking.json`` and the printed summary break each call's blocking
time into the calling thread's operators and the time between them.

Without a GPU it prints no result and exits with code 2.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
NRANKS = 4


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _random_words(torch, gen, shape):
    return torch.randint(-2**31, 2**31, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _max_abs_err(torch, a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(torch, gen, shard_rows: int, xor_words: int) -> dict:
    """Phase 4: every kernel against its plain version, bit-exact, at small
    shapes and at the main path's ``shard_rows`` and ``xor_words``."""
    import numpy as np

    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import xor_parity as xp

    stats = {}
    errs = []
    for rows in (1, 65, shard_rows):
        x = _random_words(torch, gen, (rows, 2048))
        got, want = ck.checksum(x), ref.checksum_ref(x)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"checksum ({rows}, 2048): kernel != plain "
                                 f"(max abs err {err})")
        errs.append(err)
        ms = _cuda_ms(torch, lambda: ck.checksum(x), reps=20)
        plain_ms = _cuda_ms(torch, lambda: ref.checksum_ref(x), reps=5)
        bound = _bound_ms(x.numel() * 4 + rows * 8)
        print(f"checksum ({rows}, 2048): bit-exact; kernel {ms:.4f} ms, "
              f"bound {bound:.4f} ms, plain {plain_ms:.4f} ms")
        stats["checksum"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 shape=[rows, 2048])
        del x, got, want
    stats["checksum"]["max_abs_err"] = max(errs)

    errs = []
    for k in (2, 4, 16):
        # rows laid out as ops.xor_reduce lays them: stride rounded up to 4
        for n in (1, 1001, xor_words):
            ld = -(-n // 4) * 4
            base = _random_words(torch, gen, (k, ld))
            x = base[:, :n]
            got, want = xp.xor_reduce(x), ref.xor_reduce_ref(x)
            torch.cuda.synchronize()
            err = _max_abs_err(torch, got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"xor_reduce K={k} N={n} ld={ld}: "
                                     f"kernel != plain (max abs err {err})")
            errs.append(err)
            ms = _cuda_ms(torch, lambda: xp.xor_reduce(x), reps=20)
            plain_ms = _cuda_ms(torch, lambda: ref.xor_reduce_ref(x), reps=5)
            bound = _bound_ms(4 * k * n + 4 * n)
            print(f"xor_reduce K={k} N={n} row stride {ld}: bit-exact; "
                  f"kernel {ms:.4f} ms, bound {bound:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
            if k == NRANKS and n == xor_words:
                stats["xor_reduce"] = dict(ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound, shape=[k, n])
            del base, x, got, want
    stats["xor_reduce"]["max_abs_err"] = max(errs)
    try:  # rows that are not 16-byte aligned are refused, not launched
        xp.xor_reduce(_random_words(torch, gen, (2, 1001)))
    except ValueError:
        pass
    else:
        raise AssertionError("xor_reduce launched on misaligned rows")

    # what a digest of host bytes costs around the kernel: the copy in
    nbytes = shard_rows * 2048 * 4
    host = np.random.default_rng(0).integers(
        0, 256, size=nbytes, dtype=np.uint8)
    src = torch.from_numpy(host)
    h2d_ms = _cuda_ms(torch, lambda: src.to("cuda"), reps=5)
    t0 = time.perf_counter()
    for _ in range(3):
        ops.digest(host)
    digest_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"digest of {nbytes} host bytes: host-to-device copy "
          f"{h2d_ms:.3f} ms, checksum kernel {stats['checksum']['ms']:.4f} "
          f"ms, whole ops.digest {digest_ms:.3f} ms (host clock)")
    stats["h2d_ms"] = h2d_ms
    return stats


def _deal(leaves, nranks):
    """Leaves to ranks, largest first onto the lightest rank; paths kept."""
    out = [dict() for _ in range(nranks)]
    load = [0] * nranks
    for name, t in sorted(leaves, key=lambda kv: -kv[1].numel()
                          * kv[1].element_size()):
        r = load.index(min(load))
        out[r][name] = t
        load[r] += t.numel() * t.element_size()
    return out, load


def _assert_equal(torch, got: dict, want: dict, what: str):
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: leaf names differ")
    for k, t in want.items():
        g = got[k]
        if g.device != t.device or g.dtype != t.dtype \
                or not torch.equal(g, t):
            raise AssertionError(f"{what}: leaf {k!r} differs")


def make_state(torch, seed: int):
    """The full veloc-demo-100m train state on the card, dealt to ranks."""
    from repro_torch.configs import get_config
    from repro_torch.core.capture import leaves_with_paths
    from repro_torch.train.steps import init_train_state

    cfg = get_config("veloc-demo-100m")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_train_state(cfg, generator=gen, device="cuda")
    leaves = leaves_with_paths(state)
    ranks, load = _deal(leaves, NRANKS)
    print(f"veloc-demo-100m train state: {len(leaves)} leaves, {sum(load)} "
          f"bytes on cuda; per rank {load}")
    return leaves, ranks, load


class GilProbe:
    """A thread that sleeps 1 ms at a time and records how late it wakes.
    Past the scheduler's jitter, that lateness is time during which other
    threads held the interpreter lock."""

    def __init__(self):
        import threading

        self.late_ms: list[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t = time.perf_counter()
            time.sleep(0.001)
            self.late_ms.append((time.perf_counter() - t) * 1e3 - 1.0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        late = sorted(self.late_ms)
        return {"wakes": len(late), "max_ms": late[-1],
                "p99_ms": late[int(0.99 * (len(late) - 1))],
                "ms_late_over_10ms": sum(x for x in late if x > 10.0)}


def _load_trace(trace_file: Path) -> list[dict]:
    import gzip

    with gzip.open(trace_file, "rt") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def blocking_breakdown(events: list[dict], calls: list[str]) -> list[dict]:
    """Break each ``record_function`` window named in ``calls`` down from the
    events of a ``torch.profiler`` chrome trace, on the calling thread only:
    its length; the time covered by its operators (torch releases the
    interpreter lock inside them) and the time between them (Python, waiting
    for the lock or for a core); the CUDA runtime calls it made, by name;
    and how long other threads spent in ``cudaMemcpyAsync`` (the backend's
    copies from and to pageable memory) inside the window."""
    out = []
    for name in calls:
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == name]
        if not win:
            out.append({"call": name, "missing": True})
            continue
        w = win[0]
        t0, t1 = w["ts"], w["ts"] + w["dur"]
        mine = [e for e in events if e["tid"] == w["tid"] and e is not w
                and t0 <= e["ts"] < t1]
        covered, end = 0.0, t0
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in mine
                           if e.get("cat") == "cpu_op"):
            covered += max(0.0, b - max(a, end))
            end = max(end, b)
        runtime: dict = {}
        for e in mine:
            if e.get("cat") == "cuda_runtime":
                runtime[e["name"]] = runtime.get(e["name"], 0.0) + e["dur"]
        others = sum(min(t1, e["ts"] + e["dur"]) - max(t0, e["ts"])
                     for e in events
                     if e["tid"] != w["tid"] and e.get("cat") == "cuda_runtime"
                     and e["name"] == "cudaMemcpyAsync"
                     and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
        out.append({
            "call": name, "ms": w["dur"] / 1e3, "in_ops_ms": covered / 1e3,
            "between_ops_ms": (w["dur"] - covered) / 1e3,
            "runtime_ms": {k: v / 1e3 for k, v in sorted(
                runtime.items(), key=lambda kv: -kv[1]) if v >= 100.0},
            "other_threads_cudaMemcpyAsync_ms": others / 1e3})
    return out


def device_time(events: list[dict]) -> dict:
    """Device time by kind over the traced span (first checkpoint call to
    the last event), and the share of the span the device was idle."""
    start = min(e["ts"] for e in events if e.get("cat") == "user_annotation")
    end = max(e["ts"] + e["dur"] for e in events)
    gpu = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_kind: dict = {}
    for e in gpu:
        kind = e["name"] if e["cat"] == "gpu_memcpy" else e["cat"]
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
    busy, last = 0.0, start
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu):
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    return {"span_ms": (end - start) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (end - start), "ms_by_kind": by_kind}


def main_path(torch, leaves, ranks, scratch: Path, trace: Path | None = None
              ) -> dict:
    """Phase 3: checkpoint and restart of the full train state, 4 ranks."""
    import contextlib

    from repro_torch.core import Cluster, VelocClient, VelocConfig
    from repro_torch.core import format as fmt

    vcfg = VelocConfig(mode="async", scratch=str(scratch))
    cluster = Cluster(vcfg, nranks=NRANKS)
    clients = [VelocClient(vcfg, cluster, rank=r) for r in range(NRANKS)]
    calls = []  # (name, wall s, thread CPU s, new device segments)

    def checkpoint(r, version):
        name = f"checkpoint v{version} rank {r}"
        segs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        cpu, t = time.thread_time(), time.perf_counter()
        with torch.profiler.record_function(name):
            fut = clients[r].checkpoint(ranks[r], version=version)
        wall, cpu = time.perf_counter() - t, time.thread_time() - cpu
        segs = torch.cuda.memory_stats().get("segment.all.allocated", 0) \
            - segs
        calls.append((name, wall, cpu, segs))
        return fut

    probe = prof = None
    try:
        with contextlib.ExitStack() as stack:
            if trace is not None:
                from torch.profiler import ProfilerActivity, profile
                prof = stack.enter_context(profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                probe = stack.enter_context(GilProbe())
            t0 = time.perf_counter()
            futs = [checkpoint(r, 1) for r in range(NRANKS)]
            with torch.no_grad():  # the next training step, in place
                for _, t in leaves:
                    t.add_(1)
            futs += [checkpoint(r, 2) for r in range(NRANKS)]
            t_sub = time.perf_counter()
            for c in clients:
                if not c.wait(timeout=900):
                    raise AssertionError("pipeline did not drain in 900 s")
            torch.cuda.synchronize()
            drain = time.perf_counter() - t_sub
        for f in futs:
            if f.module_errors:
                raise AssertionError(f"module errors: {f.module_errors}")
        blocking = [f.results["app_blocking_s"] for f in futs]
        shard_bytes = [len(cluster.fetch_shard(vcfg.name, 2, r))
                       for r in range(NRANKS)]
        print(f"checkpoint v1+v2: app blocking per call (s) "
              f"{[round(b, 6) for b in blocking]}, submit {t_sub - t0:.3f} "
              f"s, drain {drain:.3f} s, v2 shard bytes {shard_bytes}")
        print("per call: wall s / calling thread CPU s / new device "
              "segments: " + "; ".join(f"{w:.4f} / {c:.4f} / {n}"
                                       for _, w, c, n in calls))
        if trace is not None:
            trace.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace / "trace.json.gz"))
            events = _load_trace(trace / "trace.json.gz")
            report = {"calls": blocking_breakdown(events,
                                                  [c[0] for c in calls]),
                      "gil_probe": probe.summary(),
                      "device": device_time(events)}
            (trace / "blocking.json").write_text(json.dumps(report, indent=1))
            for c in report["calls"]:
                print(f"trace {json.dumps(c)}")
            print(f"trace gil_probe {json.dumps(report['gil_probe'])}")
            print(f"trace device {json.dumps(report['device'])}")

        restart_s = []
        for r, c in enumerate(clients):
            t1 = time.perf_counter()
            version, got = c.restart_latest(ranks[r])
            torch.cuda.synchronize()
            restart_s.append(time.perf_counter() - t1)
            if version != 2:
                raise AssertionError(f"rank {r} restored v{version}: "
                                     f"{c.restart_diagnostics}")
            _assert_equal(torch, got, ranks[r], f"rank {r} restart")
        print(f"restart_latest per rank (s): "
              f"{[round(s, 3) for s in restart_s]}, all v2 and equal")

        cluster.fail_node(2)
        cluster.fail_node(3)
        for t in cluster.external_tiers:
            t.delete(fmt.shard_key(vcfg.name, 2, 2))
        if cluster.fetch_shard(vcfg.name, 2, 2) is not None or \
                cluster.fetch_partner_copy(vcfg.name, 2, 2, 1) is not None:
            raise AssertionError("rank 2's shard survived the node loss")
        t1 = time.perf_counter()
        version, got = clients[2].restart_latest(ranks[2])
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t1
        if version != 2:
            raise AssertionError(f"rank 2 after node loss restored "
                                 f"v{version}: {clients[2].restart_diagnostics}")
        _assert_equal(torch, got, ranks[2], "rank 2 parity rebuild")
        print(f"node loss: rank 2 rebuilt from XOR parity in {parity_s:.3f} "
              f"s, v2 and equal")
    finally:
        for c in clients:
            c.shutdown()
    return dict(shard_rows=-(-max(shard_bytes) // 8192),
                xor_words=-(-max(shard_bytes) // 4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scratch", default=str(ROOT / "build" / "chip_smoke"),
                    help="build and checkpoint directory (emptied first)")
    ap.add_argument("--trace", default=None,
                    help="profile the checkpoint calls and the drain into "
                         "this directory")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    scratch = Path(args.scratch)
    shutil.rmtree(scratch, ignore_errors=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(scratch / "kernels")

    from repro_torch.kernels import _build
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ops
    from repro_torch.kernels import xor_parity as xp

    card = _card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if ops.get_device().type != "cuda":
        raise AssertionError("the port's device is not cuda")

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"kernel build ({_build.NVCC_FLAGS[0]}): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f"; wall {time.perf_counter() - t0:.2f} s")

    leaves, ranks, _ = make_state(torch, args.seed)
    ck.LAUNCHES.reset()
    xp.LAUNCHES.reset()
    path = main_path(torch, leaves, ranks, scratch / "scratch",
                     trace=Path(args.trace) if args.trace else None)
    launches = {"checksum": ck.LAUNCHES.value,
                "xor_reduce": xp.LAUNCHES.value}
    print(f"main path launches: {launches}; v2 shard is "
          f"{path['shard_rows']} checksum rows, {path['xor_words']} XOR words")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    shutil.rmtree(scratch / "scratch", ignore_errors=True)
    del leaves, ranks

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    stats = check_kernels(torch, gen, shard_rows=path["shard_rows"],
                          xor_words=path["xor_words"])

    src = {"checksum": ("src/repro_torch/csrc/checksum.cu",
                        "src/repro/kernels/checksum.py:31"),
           "xor_reduce": ("src/repro_torch/csrc/xor_parity.cu",
                          "src/repro/kernels/xor_parity.py:28")}
    kernels = []
    for name in ("checksum", "xor_reduce"):
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": s["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
