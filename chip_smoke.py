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
  4. the delta path: the same state and ranks under the default async
     ``VelocConfig(delta=True, device_delta=True)`` (64 KiB chunks, chain
     of at most 8, XOR group 4, L3 flush).  v1 is full; before each of
     v2-v4 one element of 1% of every leaf's chunks (at least one chunk)
     is bumped in place, and 10% before v5; every version drains before the
     next.  Per version and rank it prints the capture's device-to-host
     bytes beside the shard bytes and asserts that v1 is full and v2-v5 are
     deltas, and that a 1% version copies at least 5x fewer bytes to the
     host than the rank's full state.  Every rank restores v5 through its
     4-link chain; rank 0 compacts v5 (no delta region left, the group's
     parity refreshed) and restores it; then nodes 2 and 3 fail, rank 2's
     v5 L3 shard is deleted, and rank 2 rebuilds v5 from XOR parity plus its
     chain — each equal to the live state.  Then a short host-delta run
     (one rank, ``device_delta=False``, v1 plus one 1% version);
  5. the q8 path: the same state and ranks under
     ``VelocConfig(mode="async", encoding="q8")`` (partner, XOR group 4,
     L3 flush).  Checkpoint v1, drain, every rank's ``restart_latest``:
     each float leaf of at least 1024 elements equals the q8 round trip of
     the plain versions on the card and lies within half a scale step of
     the live leaf, every other leaf equals it.  Per rank it prints the
     shard bytes beside the raw bytes; then node loss and the parity
     rebuild of rank 2, equal to its q8 restore;
  6. the device L2 ring: four slots on the card, each leaf split in 4 along
     its first axis where that divides by 4, else whole;
     ``core.partner.encode_l2`` in partner mode (slot g holds slot g-1's
     padded buffer) and in xor mode (12 XOR-pair launches; each slot's
     stripe equals the host oracle, and slot 2 is rebuilt from the
     survivors and the parity);
  6b. the recovery path (``recovery_path``): the full state as 4
     data-parallel ranks (each leaf split in 4 along its first axis) under
     delta, device delta, aggregation, rolling packs of 2, the catalog,
     peer seal copies, partner copies and two XOR groups of 2; v1-v4, the
     open pack sealed at shutdown; then (a) a fresh cluster restores
     through the catalog with no key listing, (b) rank 0 from its partner
     copies with the external tier failing every get (none made), (c) 8
     concurrent readers of the packed mid-chain v3, one external get per
     blob, (d) an elastic restart from 4 ranks to 2, (e) rank 2 rebuilt
     from XOR parity after its L1, partner and peer copies are wiped; each
     byte for byte against the live state; a ``recovery path {...}`` JSON
     line with the restart times, external gets, listings and launches;
  7. the train path: the port's trainer
     (``repro_torch.launch.train``) at the full width of veloc-demo-100m,
     batch 8 x 256 tokens, a checkpoint every 10 steps: (a) 40 steps with a
     simulated failure after step 35 and recovery from v30, (b)
     ``--resume`` to step 50 from v40, (c) the same 40 steps without
     checkpoints, (d) run (a) with ``--phase-predictor gru``, all with
     deterministic algorithms; v10-v50 as a fresh client reads them from
     the L3 files, (d)'s v10-v40, the recovered and the resumed states are
     held byte for byte against a replay of (a) and (b) without
     checkpoints, the losses against the replay's within
     ``TRAIN_LOSS_TOL``, and a ``train path {...}`` JSON line
     gives the step times with and without checkpoints, the overhead, the
     app blocking per call, the drain and the restarts; a ``gru gate
     {...}`` line sets (d) beside (a) (step times, overhead, the loop's
     host time in ``tick`` per step, drain) and holds the GRU on the card
     against its plain CPU version on (d)'s step times (``gru_gate_check``);
  7a. the sharded state path (``sharded_path``): a one-rank NCCL group
     and ``make_host_mesh(1, 1)`` on the card; veloc-demo-100m at full
     width with ``fsdp=True``, its train state carried onto the mesh as
     DTensors by ``resolve_tree(train_state_specs(cfg))`` (the count of
     leaves per placement printed); batch 8 x 256 from
     ``SyntheticStream(mesh=)``; with deterministic algorithms, 3 sharded
     and 3 plain steps from one state, every leaf and loss bit-equal; v1 of
     the sharded state through the default sync pipeline and
     ``restart_latest(shardings=)``: DTensors on the same mesh with the same
     placements, bit-equal; the regions and external-tier files
     byte-identical to the plain state's checkpoint; a ``sharded path
     {...}`` line (step times, checkpoint blocking, restore, the phase's
     seconds); the group destroyed after;
  7b. the interval optimizer (``interval_check``): ``MLIntervalOptimizer``
     fitted on the card and on the CPU from the same parameters, their
     predictions within ``INTERVAL_ABS_TOL``, and an ``interval optimizer
     {...}`` line with the fitted best interval beside the simulator's
     best and Young/Daly;
  7c. the recurrent scans (``recurrent_scans``): the chunkwise mLSTM at
     xlstm-1.3b's shape and the log-depth RG-LRU scan at
     recurrentgemma-2b's, each within ``SCAN_ERR_RATIO`` times its f32
     reference form's error against a float64 run (a ``recurrent scans
     {...}`` line);
  7d. the xlstm train path (``xlstm_train_path``): xlstm-1.3b at full
     width cut to 24 of its 48 layers (``trainer_run`` cuts the trainer's
     config; a 12.32 GB train state) through the trainer with a checkpoint
     every 2 steps, a failure after step 3 and recovery from v2,
     ``--capture standalone``; every version read back by a fresh client,
     the recovered and the last state held against a replay without
     checkpoints by per-leaf tables computed on the card; an ``xlstm
     train path {...}`` line (step times, overhead, app blocking, waits,
     drain, restarts, peak device memory, host RSS, when the device
     snapshot was released, a profiled step) and, from the restored
     state, an ``xlstm decode {...}`` line (``decode_check``: prefill of
     240 tokens and 16 decode steps against the forward pass, f32 and
     float64);
  7e. recurrentgemma-2b cut to its first 3 layers at full width
     (``recurrentgemma_step``): 10 steps and its decode check (a
     ``recurrentgemma step {...}`` line);
  7f. the whisper train path (``whisper_train_path``): whisper-medium
     whole (24 + 24 layers, 811,657,216 parameters, a 9.74 GB train
     state) through the trainer at batch 8, frames (8, 1500, 1024) and
     tokens (8, 448), bf16 compute, ``--capture fused``, a checkpoint
     every 2 steps, a failure after step 3 and recovery from v2; a fresh
     client must restore v4; every version, the recovered and the last
     state held against a replay without checkpoints by per-leaf tables
     computed on the card, the losses within ``TRAIN_LOSS_TOL``; a
     ``whisper train path {...}`` line;
  7g. ``whisper serve from restore`` (``whisper_serve``): the fresh
     client's v4 and the live trainer's v4 each prefill frames (2, 1500,
     1024) and a 4-token prompt (self caches of ``dec_max_len``) and
     decode 16 greedy steps in bf16; logits and tokens equal bit for bit;
     the encoder's position table computed on the card beside the CPU's
     (``sinusoidal_gap``, largest gap printed);
     then ``whisper decode`` (``decode_check`` on the restored v4: prefill
     of 400 tokens and 16 decode steps against ``decode_train``, f32 at
     full depth within ``STUB_F32_TOL``, float64 cut to ``F64_LAYERS``
     layers a stack within ``F64_TOL``);
  7h. ``vision serve`` (``vision_serve``): phi-3-vision-4.2b at full width
     and depth from a seeded initialisation, 4 rows of 576 patches and 240
     text tokens served in bf16 (prefill, 16 greedy steps), then its
     decode check as in 7g;
  7i. ``examples`` (``examples_path``): the port's five examples
     (``repro_torch.examples``: quickstart, incremental, serve,
     branch_explore, train_resilient) on the card at their own sizes, each
     to its "OK": seconds, checksum and block-hash launches, incremental's
     per-version table, serve's replica held to the primary bit for bit;
  7j. ``serve clone`` (``serve_clone``): DeepClone at full width,
     phi3-mini-3.8b whole serving 4 rows (prefill 256 tokens into caches of
     512, 32 greedy bf16 steps); after step 12 an async checkpoint clones
     params, caches, token and position while decoding goes on until the
     clone has drained; a fresh client restores it from a ``meta`` template
     and continues: logits and tokens bit for bit, per-leaf tables equal;
     app blocking, decode ms before, during and after the drain, drain,
     fresh restore, peak device memory;
  7k. ``minicpm3 mla serve clone``: the same clone of minicpm3-4b's MLA
     form whole (62 layers, 4,262,025,728 parameters), its caches the
     latent and the shared rotated key (73,138,176 bytes), printed beside
     the plain-attention form's K/V cache bytes, computed; then
     ``minicpm3 decode``: ``decode_check`` of both forms (the registered
     plain attention and MLA) at full width cut to 4 layers (f32 within
     ``STUB_F32_TOL``, float64 within ``F64_TOL``);
  7l. ``grok serve clone``: the same clone of grok-1-314b at full width
     cut to one layer (8 experts of d_ff 32,768, top-2; 6,530,598,912
     parameters in bf16, K/V caches of 8,388,608 bytes), with the
     prefill's routing: dropped slots and the fewest and most slots an
     expert was routed and kept (``routing_stats``);
  7m. ``grok decode``: ``decode_check`` of that layer at capacity factor
     E/k (no slot drops), its parameters drawn anew in f32, then in
     float64 (f32 within ``STUB_F32_TOL``, float64 within ``F64_TOL``);
  7n. ``kimi serve``: kimi-k2-1t-a32b at full width cut to one layer (384
     experts of d_ff 2048, top-8; 19,378,623,488 parameters, 38.76 GB in
     bf16): 4 rows, a 256-token prompt, 16 greedy bf16 steps, the
     prefill's routing, peak device memory; not cloned (its clone would
     pass through the host's memory);
  8. each kernel against its plain PyTorch version on the card, bit-exact,
     at small shapes and at the exact shapes the paths gave it (one shard's
     checksum rows, the train path's one-rank shard, the xlstm and
     whisper paths' largest regions and the three serve clones' largest
     leaves; the XOR group's words in the aligned row layout of
     ``ops.xor_reduce``; the largest leaf's and the 0-d ``opt/step`` leaf's
     words in 64 KiB rows for the block hash and its fused diff; the dirty
     rows of a 1% and of a 10% version of the largest leaf for the gather,
     and index lists on either side of each capacity of its launch
     parameters, the longest split into several launches (counted); the
     largest leaf's values for quantize and dequantize, and ragged,
     misaligned, NaN, ±inf, all-zero and f16 blocks; the ring's stripe for
     the XOR pair, and ragged, block-multiple and misaligned words), with
     the kernel's median time from CUDA events (each call's inputs evicted
     from L2 first, no wait for the host; ``_cuda_ms``), its bound, the
     plain version's time and, where one PyTorch call computes the same
     function, that call's time; for the gather at both shapes also the
     whole call on the host clock until the device is done (``_host_ms``:
     host checks, launch, kernel, wait) beside ``torch.index_select`` with
     its index copied from the host, timed the same way; and the
     host-to-device copy of a shard-sized buffer next to the checksum
     kernel that digests it;
  9. a ``phase seconds {...}`` line (for each JSON line above, the seconds
     since the line before it; and the kernel checks' seconds), then a
     ``{"kernels": [...]}`` line: each kernel's launches on its path and
     on every path (counts set to 0 just before each path), times, bound
     and error;
 10. as the last line, ``{"ok": true, "device": {...}}``.

``--trace DIR`` also records the checkpoint calls and the drain with
``torch.profiler`` (``DIR/trace.json.gz``) and runs a probe thread that
measures how long the interpreter lock is held away from it;
``DIR/blocking.json`` and the printed summary break each call's blocking
time into the calling thread's operators and the time between them.

Without a GPU it prints no result and exits with code 2.
"""
from __future__ import annotations

import argparse
import contextlib
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
L2_FLUSH_WORDS = 64 << 20  # 256 MiB of int32, five times the H100's 50 MB L2
SPIN_CYCLES = 20_000_000  # ~10 ms of device time at the H100's clocks
PROFILE_TOP = 8  # kernels named in a profiled step, by device time


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current stream, its inputs in
    device memory and not in L2: the median over ``reps`` calls, each
    between two CUDA events and each after a read of a 256 MiB buffer that
    evicts whatever the call before left in L2 (a read leaves clean lines,
    so the call pays no write-back of the flush).  A spin of the device
    first lets the host queue every call before the device reaches it, so a
    call's time holds no wait for the host unless ``fn`` itself waits for
    the device (a copy from pageable memory); then the wait is its cost."""
    flush = torch.empty(L2_FLUSH_WORDS, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for a, b in events:
        torch.sum(flush)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def _host_ms(torch, fn, reps: int, warmup: int = 2, wait: bool = True,
             flush: bool = True) -> float:
    """Milliseconds of one call of ``fn`` as its caller waits for it: the
    host clock from the call until ``torch.cuda.synchronize()`` returns
    (host work, launches, the device's work and the wait), the median over
    ``reps`` calls, each made on an idle device, after a read of a 256 MiB
    buffer that evicts L2 unless ``flush`` is false (then the host thread
    has not just waited ~0.1 ms for the device).  With ``wait=False`` the
    clock stops when ``fn`` returns: its host work alone (and any wait
    inside it)."""
    buf = (torch.empty(L2_FLUSH_WORDS, dtype=torch.int32, device="cuda")
           if flush else None)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if buf is not None:
            torch.sum(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if wait:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _random_words(torch, gen, shape):
    return torch.randint(-2**31, 2**31, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _max_abs_err(torch, a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(torch, gen, shard_rows: int, xor_words: int,
                  train_rows: int, regions: dict) -> dict:
    """Phase 8: every kernel against its plain version, bit-exact, at small
    shapes, at the main path's ``shard_rows`` and ``xor_words``, at the
    train path's ``train_rows`` (its one-rank shard) and at each of
    ``regions`` (path name -> rows of the largest table that path's state
    checks launch: the xlstm and whisper paths' largest regions, the serve
    clones' largest leaves); the times kept are the main path's, and each
    region's beside them under its path's name."""
    import numpy as np

    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import xor_parity as xp

    stats = {}
    errs = []
    shapes = [(None, 1), (None, 65), (None, train_rows),
              *regions.items(), (None, shard_rows)]
    region_stats = {}
    for region, rows in shapes:
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
        if region is not None:
            region_stats[region] = dict(stats["checksum"])
        del x, got, want
    stats["checksum"].update(region_stats)
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


def _check_exact(torch, what: str, got, want) -> int:
    """Bit-exact comparison of tensors or tuples of them; float tensors are
    compared by their bits (NaN included).  Returns the largest absolute
    difference of the integer values or float bits."""
    torch.cuda.synchronize()
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    bits = [(g.view(torch.int32), w.view(torch.int32))
            if g.dtype == w.dtype == torch.float32 else (g, w)
            for g, w in zip(got, want)]
    err = max(_max_abs_err(torch, g, w) for g, w in bits)
    if not all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
               for g, w in bits):
        raise AssertionError(f"{what}: kernel != plain (max abs err {err})")
    return err


def check_delta_kernels(torch, gen, big_words: int, step_words: int,
                        dirty_rows: int, dirty_rows_10: int,
                        chunk: int) -> dict:
    """Phase 8 for the delta path's kernels: block hash, fused hash-diff
    and row gather against their plain versions, bit-exact, at small,
    ragged and misaligned shapes and at the path's own: the largest leaf's
    ``big_words`` words and the 0-d ``opt/step`` leaf's ``step_words`` in
    rows of ``chunk`` words, and ``dirty_rows`` and ``dirty_rows_10``
    gathered rows of the largest leaf (its 1 % and 10 % versions).  The
    gather is also held at index lists on either side of each capacity of
    its launch parameters and at one longer than the largest, which the
    wrapper splits into several launches."""
    from repro_torch.kernels import blockhash as bh
    from repro_torch.kernels import gather as ga
    from repro_torch.kernels import ref

    stats = {}
    errs = {"blockhash": [], "blockhash_diff": [], "gather_rows": []}
    # (words, chunk, misaligned): the path's two shapes first, then small,
    # ragged, chunk % 4 != 0 (scalar loads) and a base 4 bytes off 16
    cases = [(big_words, chunk, False), (step_words, chunk, False),
             (5, 7, False), (3 * chunk + 5, chunk, False),
             (1001, 12, True), (4 * 1030 + 3, 1030, False)]
    for n, c, off in cases:
        x = _random_words(torch, gen, (n + 1,))[1:] if off \
            else _random_words(torch, gen, (n,))
        rows = -(-n // c)
        what = f"({n} words, chunk {c}{', misaligned' if off else ''})"

        def plain_fp(x=x, c=c, rows=rows):
            return ref.blockhash_ref(bh._padded(x, c, rows))

        want = plain_fp()
        errs["blockhash"].append(_check_exact(
            torch, f"blockhash {what}", bh.blockhash(x, c), want))
        prev = want.clone()
        prev[::3, 1] ^= 1  # every third row dirty, by a low-bit flip
        errs["blockhash_diff"].append(_check_exact(
            torch, f"blockhash_diff {what}", bh.blockhash_diff(x, prev, c),
            ref.blockhash_diff_ref(bh._padded(x, c, rows), prev)))
        gathers = ((("gather_rows", dirty_rows), ("gather_10", dirty_rows_10))
                   if n == big_words else ((None, 3),))
        for key, k in gathers:
            k = max(1, min(rows, k))
            idx = torch.randperm(rows, generator=gen, device="cuda")[:k].cpu()
            idx[-1] = rows - 1  # the (possibly ragged) last row
            errs["gather_rows"].append(_check_exact(
                torch, f"gather_rows {what} x {k}",
                ga.gather_rows(x, idx, c),
                ref.gather_rows_ref(bh._padded(x, c, rows), idx.cuda())))
            if key is not None:
                stats[key] = _time_gather(torch, x, c, idx, what)
        if off or (n, c) not in ((big_words, chunk), (step_words, chunk)):
            continue
        nbytes = 4 * n
        ms = _cuda_ms(torch, lambda: bh.blockhash(x, c), reps=20)
        plain_ms = _cuda_ms(torch, plain_fp, reps=5)
        bound = _bound_ms(nbytes + 8 * rows)
        print(f"blockhash {what}: bit-exact; kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms, plain {plain_ms:.4f} ms")
        diff_ms = _cuda_ms(torch, lambda: bh.blockhash_diff(x, prev, c),
                           reps=20)
        diff_plain = _cuda_ms(torch, lambda: ref.blockhash_diff_ref(
            bh._padded(x, c, rows), prev), reps=5)
        diff_bound = _bound_ms(nbytes + 20 * rows)
        print(f"blockhash_diff {what}: bit-exact; kernel {diff_ms:.4f} ms, "
              f"bound {diff_bound:.4f} ms, plain {diff_plain:.4f} ms")
        if n == big_words:
            stats["blockhash"] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound, shape=[rows, c])
            stats["blockhash_diff"] = dict(
                ms=diff_ms, plain_ms=diff_plain, bound_ms=diff_bound,
                shape=[rows, c])
        del x, want, prev
    # index lists on either side of each capacity of the launch parameters
    # (64, 1024, MAX_INDICES), repeated indices, and lists longer than one
    # launch takes, split by the wrapper: its launches counted
    cap = ga.MAX_INDICES
    for rows, c in ((4096, 64), (3001, 10)):  # 16-byte and word copies
        x = _random_words(torch, gen, (rows * c - 5,))  # a ragged last row
        for k in (1, 64, 65, 1024, 1025, cap, cap + 1, 2 * cap + 5):
            idx = torch.randint(0, rows, (k,), generator=gen, device="cuda")
            idx[-1] = rows - 1
            idx = idx.cpu()
            before = ga.LAUNCHES.value
            got = ga.gather_rows(x, idx, c)
            launches = ga.LAUNCHES.value - before
            if launches != -(-k // cap):
                raise AssertionError(f"gather_rows of {k} indices: "
                                     f"{launches} launches, not "
                                     f"{-(-k // cap)}")
            errs["gather_rows"].append(_check_exact(
                torch, f"gather_rows ({rows} rows of {c}) x {k}", got,
                ref.gather_rows_ref(bh._padded(x, c, rows), idx.cuda())))
        print(f"gather_rows ({rows} rows of {c} words, ragged): bit-exact "
              f"at 1-{2 * cap + 5} indices, lists over {cap} split into "
              f"launches of at most {cap}")
        del x
    stats["gather_rows"]["at_10_percent"] = stats.pop("gather_10")
    for name, e in errs.items():
        stats[name]["max_abs_err"] = max(e)
    for bad in ([3], [-1], [0.5]):  # refused on the host, nothing launched
        before = ga.LAUNCHES.value
        try:
            ga.gather_rows(_random_words(torch, gen, (10,)), bad, 4)
        except ValueError:
            pass
        else:
            raise AssertionError(f"gather_rows launched with index {bad}")
        if ga.LAUNCHES.value != before:
            raise AssertionError("a refused gather_rows launched")
    return stats


def _time_gather(torch, x, c: int, idx, what: str) -> dict:
    """The gather at one of the delta path's shapes: ``idx`` (a CPU tensor)
    rows of ``c`` words of the flat ``x``.  The kernel alone on host int32
    indices (device time between CUDA events), beside an empty kernel
    timed the same way; the whole call as the capture makes it, sorted
    int64 numpy indices, on the host clock until the device is done
    (``_host_ms``; an empty synchronize's share and the call's host work
    alone printed beside it); the bound; the plain version;
    ``torch.index_select`` on an index already on the card; and
    ``index_select`` with its index copied from the host in the same timed
    call, on the host clock.  The host-clock calls run without the L2
    eviction before each: host work dominates them, and a wait on the
    device just before slows the host's next tens of microseconds."""
    import numpy as np

    from repro_torch.kernels import blockhash as bh
    from repro_torch.kernels import gather as ga
    from repro_torch.kernels import ref

    n, k = x.shape[0], idx.shape[0]
    rows = -(-n // c)
    host_idx = np.sort(idx.numpy().astype(np.int64))  # as the capture has it
    idx32 = np.ascontiguousarray(idx.numpy(), dtype=np.int32)
    dev_idx = idx.cuda()
    out = torch.empty((k, c), dtype=torch.int32, device="cuda")
    ms = _cuda_ms(torch, lambda: ga.launch(x, c, idx32, out), reps=20)
    empty_ms = _cuda_ms(torch, lambda: torch.cuda._sleep(0), reps=20)
    call_ms = _host_ms(torch, lambda: ga.gather_rows(x, host_idx, c),
                       reps=50, flush=False)
    host_ms = _host_ms(torch, lambda: ga.gather_rows(x, host_idx, c),
                       reps=50, wait=False, flush=False)
    sync_ms = _host_ms(torch, lambda: None, reps=50, flush=False)
    plain_ms = _cuda_ms(torch, lambda: ref.gather_rows_ref(
        bh._padded(x, c, rows), dev_idx), reps=5)
    full = x[:(n // c) * c].view(n // c, c)  # index_select takes full rows
    lib_idx = dev_idx.clamp(max=n // c - 1)
    lib_ms = _cuda_ms(torch, lambda: torch.index_select(full, 0, lib_idx),
                      reps=20)
    cpu_idx = torch.from_numpy(host_idx).clamp(max=n // c - 1)
    lib_copy_ms = _host_ms(torch, lambda: torch.index_select(
        full, 0, cpu_idx.to("cuda")), reps=50, flush=False)
    bound = _bound_ms(2 * k * c * 4 + 4 * k)
    print(f"gather_rows {what} x {k} rows: bit-exact; kernel alone "
          f"{ms:.4f} ms (an empty kernel {empty_ms:.4f}), bound "
          f"{bound:.6f} ms ({bound / ms:.1%} of the kernel's time), whole "
          f"call {call_ms:.4f} ms (host clock; its host work alone "
          f"{host_ms:.4f}, an empty synchronize {sync_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, torch.index_select {lib_ms:.4f} ms (index on "
          f"the card), with the index copied from the host {lib_copy_ms:.4f} "
          f"ms (host clock)")
    return dict(ms=ms, empty_kernel_ms=empty_ms, call_ms=call_ms,
                call_host_ms=host_ms, sync_ms=sync_ms, plain_ms=plain_ms,
                bound_ms=bound, library_ms=lib_ms,
                library_with_index_copy_ms=lib_copy_ms, shape=[k, c])


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


def _bump_chunks(torch, gen, leaves, chunk_bytes: int, per: int):
    """In place on the card: add 1 to the first element of
    ``max(1, rows // per)`` chunks of every leaf, chosen by ``gen``."""
    with torch.no_grad():
        for _, t in leaves:
            rows = -(-t.numel() * t.element_size() // chunk_bytes)
            pick = torch.randperm(rows, generator=gen, device=t.device)[
                :max(1, rows // per)]
            flat = t.view(-1)
            flat[pick * (chunk_bytes // t.element_size())] += 1


def delta_path(torch, leaves, ranks, load, scratch: Path, seed: int) -> dict:
    """Phase 4: device-delta checkpoints v1-v5 of the full train state, 4
    ranks; restart through the chain, compaction, parity rebuild."""
    from repro_torch.core import Cluster, VelocClient, VelocConfig
    from repro_torch.core import format as fmt
    from repro_torch.core import restart as rst

    vcfg = VelocConfig(mode="async", scratch=str(scratch), delta=True,
                       device_delta=True)
    cluster = Cluster(vcfg, nranks=NRANKS)
    clients = [VelocClient(vcfg, cluster, rank=r) for r in range(NRANKS)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    chunk_bytes = vcfg.delta_chunk_bytes
    d2h_prev = [0] * NRANKS
    per_version = []
    try:
        for v, per in ((1, None), (2, 100), (3, 100), (4, 100), (5, 10)):
            if per is not None:
                _bump_chunks(torch, gen, leaves, chunk_bytes, per)
            t0 = time.perf_counter()
            futs = [c.checkpoint(ranks[r], version=v)
                    for r, c in enumerate(clients)]
            t_sub = time.perf_counter()
            for c in clients:
                if not c.wait(timeout=600):
                    raise AssertionError(f"v{v} did not drain in 600 s")
            drain = time.perf_counter() - t_sub
            row = {"version": v, "dirty_per": per, "submit_s": t_sub - t0,
                   "drain_s": drain, "ranks": []}
            for r, (c, f) in enumerate(zip(clients, futs)):
                if f.module_errors:
                    raise AssertionError(f"v{v} rank {r}: {f.module_errors}")
                d2h = c.device_capture.stats["d2h_bytes"]
                row["ranks"].append({
                    "kind": f.results["delta_kind"],
                    "d2h_bytes": d2h - d2h_prev[r],
                    "shard_bytes": len(cluster.fetch_shard(vcfg.name, v, r)),
                    "full_bytes": load[r],
                    "blocking_s": f.results["app_blocking_s"],
                    "dirty_ratio": f.results["delta_dirty_ratio"]})
                d2h_prev[r] = d2h
            what = "full" if per is None else f"1/{per} of chunks dirtied"
            print(f"delta v{v} ({what}): "
                  f"submit {row['submit_s']:.3f} s, drain {drain:.3f} s; "
                  "per rank kind / D2H bytes / shard bytes / full bytes: "
                  + "; ".join(f"{x['kind']} / {x['d2h_bytes']} / "
                              f"{x['shard_bytes']} / {x['full_bytes']}"
                              for x in row["ranks"]))
            want = "full" if v == 1 else "delta"
            if any(x["kind"] != want for x in row["ranks"]):
                raise AssertionError(f"v{v}: expected {want} on every rank, "
                                     f"got {[x['kind'] for x in row['ranks']]}")
            if per == 100:
                for r, x in enumerate(row["ranks"]):
                    if x["d2h_bytes"] * 5 > x["full_bytes"]:
                        raise AssertionError(
                            f"v{v} rank {r}: {x['d2h_bytes']} D2H bytes at 1% "
                            f"dirty, not 5x below {x['full_bytes']}")
            per_version.append(row)

        restart_s = []
        for r, c in enumerate(clients):
            chain = rst.chain_versions(cluster, vcfg.name, 5, r)
            if chain != [5, 4, 3, 2, 1]:
                raise AssertionError(f"rank {r} chain {chain}")
            t1 = time.perf_counter()
            version, got = c.restart_latest(ranks[r])
            torch.cuda.synchronize()
            restart_s.append(time.perf_counter() - t1)
            if version != 5:
                raise AssertionError(f"rank {r} restored v{version}: "
                                     f"{c.restart_diagnostics}")
            _assert_equal(torch, got, ranks[r], f"rank {r} chain restart")
        print(f"delta restart_latest through the 4-link chain per rank (s): "
              f"{[round(x, 3) for x in restart_s]}, all v5 and equal")

        t1 = time.perf_counter()
        if clients[0].compact() != 5:
            raise AssertionError("compact() did not fold v5")
        compact_s = time.perf_counter() - t1
        reader = fmt.ShardReader(cluster.fetch_shard(vcfg.name, 5, 0))
        if reader.delta_regions():
            raise AssertionError("compacted shard still holds delta regions")
        if not clients[0].refresh_parity(5):
            raise AssertionError("parity refresh after compaction failed")
        t1 = time.perf_counter()
        version, got = clients[0].restart_latest(ranks[0])
        torch.cuda.synchronize()
        compact_restart_s = time.perf_counter() - t1
        if version != 5:
            raise AssertionError(f"rank 0 after compaction restored "
                                 f"v{version}: {clients[0].restart_diagnostics}")
        _assert_equal(torch, got, ranks[0], "rank 0 compacted restart")
        print(f"compact v5 on rank 0: {compact_s:.3f} s, shard "
              f"{len(cluster.fetch_shard(vcfg.name, 5, 0))} bytes, no delta "
              f"region; restart {compact_restart_s:.3f} s, v5 and equal")

        cluster.fail_node(2)
        cluster.fail_node(3)
        for t in cluster.external_tiers:
            t.delete(fmt.shard_key(vcfg.name, 5, 2))
        if cluster.fetch_shard(vcfg.name, 5, 2) is not None or \
                cluster.fetch_partner_copy(vcfg.name, 5, 2, 1) is not None:
            raise AssertionError("rank 2's v5 shard survived the node loss")
        t1 = time.perf_counter()
        version, got = clients[2].restart_latest(ranks[2])
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t1
        if version != 5:
            raise AssertionError(f"rank 2 after node loss restored "
                                 f"v{version}: {clients[2].restart_diagnostics}")
        _assert_equal(torch, got, ranks[2], "rank 2 delta parity rebuild")
        print(f"node loss: rank 2 rebuilt v5 from XOR parity plus its chain "
              f"in {parity_s:.3f} s, equal")
        big = max((t for _, t in leaves), key=lambda t: t.numel())
        big_rows = -(-big.numel() * big.element_size() // chunk_bytes)
        stats = dict(clients[0].device_capture.stats)
    finally:
        for c in clients:
            c.shutdown()
    return dict(versions=per_version, restart_s=restart_s,
                compact_s=compact_s, compact_restart_s=compact_restart_s,
                parity_s=parity_s, capture_stats_rank0=stats,
                big_words=big.numel() * big.element_size() // 4,
                # the largest leaf's dirty rows at 1 % and 10 %, as
                # _bump_chunks picks them
                dirty_rows=max(1, big_rows // 100),
                dirty_rows_10=max(1, big_rows // 10),
                chunk_words=chunk_bytes // 4)


def host_delta_path(torch, leaves, state, scratch: Path, seed: int) -> dict:
    """Phase 4, host side: one rank, ``delta=True, device_delta=False``, v1
    and one 1% version; the fingerprints hash host bytes."""
    from repro_torch.core import Cluster, VelocClient, VelocConfig

    vcfg = VelocConfig(mode="async", scratch=str(scratch), delta=True,
                       partner=False, xor_group=0)
    client = VelocClient(vcfg, Cluster(vcfg, nranks=1))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    try:
        for v in (1, 2):
            if v == 2:
                _bump_chunks(torch, gen, leaves, vcfg.delta_chunk_bytes, 100)
            t0 = time.perf_counter()
            f = client.checkpoint(state, version=v)
            if not client.wait(timeout=600):
                raise AssertionError(f"host delta v{v} did not drain")
            if f.module_errors:
                raise AssertionError(f"host delta v{v}: {f.module_errors}")
            out.append({"kind": f.results["delta_kind"],
                        "shard_bytes": f.results["shard_bytes"],
                        "s": time.perf_counter() - t0})
        version, got = client.restart_latest(state)
        if [x["kind"] for x in out] != ["full", "delta"] or version != 2:
            raise AssertionError(f"host delta: {out}, restored v{version}")
        _assert_equal(torch, got, state, "host delta restart")
    finally:
        client.shutdown()
    print("host delta (1 rank): " + "; ".join(
        f"v{i + 1} {x['kind']} {x['shard_bytes']} bytes in {x['s']:.3f} s"
        for i, x in enumerate(out)) + "; restart v2 equal")
    return {"versions": out}


def _q8_expected(torch, leaf):
    """What a q8 restore of ``leaf`` must give, from the plain versions on
    the card, and the per-element bound of its error: half the block's
    scale, plus the two roundings (the division, the product) at most
    2 * 127 * 2**-24 of it."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    n = leaf.numel()
    q, s = ref.quantize_flat_ref(leaf.detach().reshape(-1).float())
    want = ref.dequantize_ref(q, s).reshape(-1)[:n]
    bound = (s.double() * (0.5 + 2.0 ** -16)).repeat_interleave(
        qz.BLOCK_SIZE)[:n]
    return want.reshape(leaf.shape).to(leaf.dtype), bound


def _assert_q8_restore(torch, got: dict, live: dict, what: str) -> int:
    """Each float leaf of at least 1024 elements equal to the plain q8
    round trip and within its bound of the live leaf; every other leaf
    equal to the live one.  Returns the count of quantized leaves."""
    if sorted(got) != sorted(live):
        raise AssertionError(f"{what}: leaf names differ")
    quantized = 0
    for k, t in live.items():
        g = got[k]
        if g.device != t.device or g.dtype != t.dtype:
            raise AssertionError(f"{what}: leaf {k!r} device or dtype")
        if not (t.is_floating_point() and t.numel() >= 1024):
            if not torch.equal(g, t):
                raise AssertionError(f"{what}: raw leaf {k!r} differs")
            continue
        want, bound = _q8_expected(torch, t)
        if not torch.equal(g.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{what}: leaf {k!r} != the plain q8 round "
                                 f"trip")
        err = (g.double() - t.double()).abs().reshape(-1)
        if bool((err > bound).any()):
            raise AssertionError(f"{what}: leaf {k!r} off by more than half "
                                 f"a scale step ({float(err.max())})")
        quantized += 1
    return quantized


def q8_path(torch, ranks, load, scratch: Path) -> dict:
    """Phase 5, the q8 path: ``VelocConfig(mode="async", encoding="q8")``
    over the full state and the 4 ranks: checkpoint v1, drain, every
    rank's restart, then node loss and the parity rebuild of rank 2."""
    from repro_torch.core import Cluster, VelocClient, VelocConfig
    from repro_torch.core import format as fmt

    vcfg = VelocConfig(mode="async", encoding="q8", scratch=str(scratch))
    cluster = Cluster(vcfg, nranks=NRANKS)
    clients = [VelocClient(vcfg, cluster, rank=r) for r in range(NRANKS)]
    try:
        t0 = time.perf_counter()
        futs = [c.checkpoint(ranks[r], version=1)
                for r, c in enumerate(clients)]
        t_sub = time.perf_counter()
        for c in clients:
            if not c.wait(timeout=900):
                raise AssertionError("q8 pipeline did not drain in 900 s")
        drain = time.perf_counter() - t_sub
        for f in futs:
            if f.module_errors:
                raise AssertionError(f"q8 module errors: {f.module_errors}")
        shard_bytes = [len(cluster.fetch_shard(vcfg.name, 1, r))
                       for r in range(NRANKS)]
        print(f"q8 v1: submit {t_sub - t0:.3f} s, drain {drain:.3f} s; per "
              f"rank shard bytes / raw bytes / ratio: " + "; ".join(
                  f"{b} / {raw} / {raw / b:.4f}x"
                  for b, raw in zip(shard_bytes, load)))
        restart_s, quantized = [], 0
        for r, c in enumerate(clients):
            t1 = time.perf_counter()
            version, got = c.restart_latest(ranks[r])
            torch.cuda.synchronize()
            restart_s.append(time.perf_counter() - t1)
            if version != 1:
                raise AssertionError(f"q8 rank {r} restored v{version}: "
                                     f"{c.restart_diagnostics}")
            quantized += _assert_q8_restore(torch, got, ranks[r],
                                            f"q8 rank {r} restart")
        print(f"q8 restart_latest per rank (s): "
              f"{[round(x, 3) for x in restart_s]}; {quantized} quantized "
              f"leaves equal to the plain q8 round trip and within half a "
              f"scale step, the rest equal")

        cluster.fail_node(2)
        cluster.fail_node(3)
        for t in cluster.external_tiers:
            t.delete(fmt.shard_key(vcfg.name, 1, 2))
        if cluster.fetch_shard(vcfg.name, 1, 2) is not None or \
                cluster.fetch_partner_copy(vcfg.name, 1, 2, 1) is not None:
            raise AssertionError("q8: rank 2's shard survived the node loss")
        t1 = time.perf_counter()
        version, got = clients[2].restart_latest(ranks[2])
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t1
        if version != 1:
            raise AssertionError(
                f"q8 rank 2 after node loss restored v{version}: "
                f"{clients[2].restart_diagnostics}")
        _assert_q8_restore(torch, got, ranks[2], "q8 rank 2 parity rebuild")
        print(f"q8 node loss: rank 2 rebuilt from XOR parity in "
              f"{parity_s:.3f} s, equal to its q8 restore")
    finally:
        for c in clients:
            c.shutdown()
    return dict(drain_s=drain, restart_s=restart_s, parity_s=parity_s,
                shard_bytes=shard_bytes, raw_bytes=list(load))


def ring_slots(torch, leaves, n: int = NRANKS):
    """``n`` slots (4 unless stated) as data-parallel ranks hold the state:
    each leaf split in ``n`` along its first axis where that divides by 4
    (``P("data", ...)``), else whole (replicated).  Views of the leaves."""
    slots = [dict() for _ in range(n)]
    for name, t in leaves:
        split = t.dim() > 0 and t.shape[0] % NRANKS == 0
        k = t.shape[0] // n if split else 0
        for g in range(n):
            slots[g][name] = t[g * k:(g + 1) * k] if split else t
    return slots


def ring_path(torch, leaves) -> dict:
    """Phase 6, the device L2 ring over 4 slots of the full state on the
    card: partner mode (slot g holds slot g-1's padded buffer), then xor mode
    (each slot's stripe against the host oracle; slot 2 rebuilt from the
    survivors and the parity)."""
    import numpy as np

    from repro_torch.core import partner as pt
    from repro_torch.kernels import xor_parity as xp

    slots = ring_slots(torch, leaves)
    bufs = [pt._pad_to(pt.flatten_local_u32(s), 1024) for s in slots]
    t0 = time.perf_counter()
    out = pt.encode_l2(slots, mode="partner")
    torch.cuda.synchronize()
    partner_s = time.perf_counter() - t0
    for g in range(NRANKS):
        if not torch.equal(out[g], bufs[(g - 1) % NRANKS]):
            raise AssertionError(f"ring partner: slot {g} does not hold slot "
                                 f"{(g - 1) % NRANKS}'s buffer")
    del out
    before = xp.PAIR_LAUNCHES.value
    t0 = time.perf_counter()
    par = pt.encode_l2(slots, mode="xor")
    torch.cuda.synchronize()
    xor_s = time.perf_counter() - t0
    steps = xp.PAIR_LAUNCHES.value - before
    if steps != NRANKS * (NRANKS - 1):
        raise AssertionError(f"ring xor: {steps} xor_pair launches, not "
                             f"{NRANKS * (NRANKS - 1)}")
    host = [b.cpu().numpy().view(np.uint32) for b in bufs]
    stripes = [p.cpu().numpy().view(np.uint32) for p in par]
    t0 = time.perf_counter()
    want = pt.ring_xor_parity_ref(host)
    for g in range(NRANKS):
        if not np.array_equal(stripes[g], want[g]):
            raise AssertionError(f"ring xor: slot {g}'s stripe != the host "
                                 f"oracle")
    lost = 2
    rebuilt = pt.xor_reconstruct_group(
        {g: host[g] for g in range(NRANKS) if g != lost},
        {g: stripes[g] for g in range(NRANKS) if g != lost}, lost, NRANKS,
        len(host[lost]))
    if not np.array_equal(rebuilt, host[lost]):
        raise AssertionError("ring xor: slot 2 not rebuilt from the "
                             "survivors and the parity")
    oracle_s = time.perf_counter() - t0
    words, c = int(bufs[0].numel()), int(par[0].numel())
    print(f"ring path: 4 slots of {words} words each on the card; partner "
          f"mode {partner_s:.3f} s, every slot holds its predecessor's "
          f"buffer; xor mode {xor_s:.3f} s ({steps} xor_pair launches), "
          f"stripes of {c} words equal to the host oracle; slot 2 rebuilt "
          f"from the survivors and the parity (host oracle "
          f"{oracle_s:.3f} s)")
    return dict(slot_words=words, stripe_words=c, partner_s=partner_s,
                xor_s=xor_s, oracle_s=oracle_s)


RECOVERY_VERSIONS = 4  # v1 full, v2-v4 deltas at 1 % of chunks dirty
RECOVERY_TARGET = 3    # the packed mid-chain version the readers restore
RECOVERY_READERS = 8


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _blob_keys(fmt, name, counts):
    """The segment/pack keys among a tier's observed gets."""
    return [k for k in counts
            if k.startswith(fmt.pack_prefix(name)) or k.endswith("/segment")]


def recovery_path(torch, leaves, scratch: Path, seed: int) -> dict:
    """Phase 6b, the recovery path: the full train state as 4 data-parallel
    ranks
    (``ring_slots``: each leaf split in 4 along its first axis), written
    under ``VelocConfig(delta=True, device_delta=True, aggregate=True,
    pack_versions=2, catalog=True, peer_seal_copies=True, xor_group=2)``
    (async; partner copies at distance 1; two XOR groups of 2, each
    group's parity on the other group's leader).  v1 is full, v2-v4 are
    deltas at 1 % of chunks dirty; v2 and v3 share a rolling pack; v4's
    open pack is sealed at shutdown.  Then, each result held byte for
    byte against the live state (or the copy taken at v3):

      a. a fresh cluster and client per rank restore v4 through the
         catalog, with no ``keys()`` listing on any tier;
      b. with every external tier failing its gets and node 0 lost, rank
         0 restores v4 from its partner copies on node 1: no external get;
      c. 8 concurrent readers (2 per rank) restore the packed mid-chain
         v3 from the external tier alone (fresh cluster, node tiers
         empty): one external get per segment or pack blob;
      d. an elastic restart of v4 from 4 ranks to 2;
      e. rank 2's L1 (node 2), its partner copies (on node 3) and the
         peer copies of the sealed blobs wiped, the external tier failing
         its gets and the writer's cache of its parsed blobs emptied: rank
         2's v1-v4 rebuilt from XOR parity and rank 3.

    (e) runs before (b), as (b)'s lost node 0 holds the parity (e) needs.
    Runs on the leaves' device: the card here, the CPU in a rehearsal."""
    import threading

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_helpers import CountingTier, FlakyTier, wrap_external_tiers

    from repro_torch.core import Cluster, VelocClient, VelocConfig
    from repro_torch.core import format as fmt
    from repro_torch.core import restart as rst
    from repro_torch.core.capture import tree_from_regions
    from repro_torch.kernels import ops

    vcfg = VelocConfig(mode="async", scratch=str(scratch), delta=True,
                       device_delta=True, aggregate=True, pack_versions=2,
                       catalog=True, peer_seal_copies=True, xor_group=2,
                       keep_versions=10)
    name = vcfg.name
    slots = ring_slots(torch, leaves)
    gen = torch.Generator(device=leaves[0][1].device).manual_seed(seed)
    cluster = Cluster(vcfg, nranks=NRANKS)
    clients = [VelocClient(vcfg, cluster, rank=r) for r in range(NRANKS)]
    kinds, kept, write_s = [], None, []
    try:
        for v in range(1, RECOVERY_VERSIONS + 1):
            if v > 1:
                _bump_chunks(torch, gen, leaves, vcfg.delta_chunk_bytes, 100)
            t0 = time.perf_counter()
            futs = [c.checkpoint(slots[r], version=v)
                    for r, c in enumerate(clients)]
            for c in clients:
                if not c.wait(timeout=600):
                    raise AssertionError(f"recovery v{v} did not drain")
            write_s.append(time.perf_counter() - t0)
            for r, f in enumerate(futs):
                if f.module_errors:
                    raise AssertionError(f"recovery v{v} rank {r}: "
                                         f"{f.module_errors}")
            kinds.append([f.results["delta_kind"] for f in futs])
            if v == RECOVERY_TARGET:
                kept = [{k: t.clone() for k, t in s.items()} for s in slots]
    finally:
        t0 = time.perf_counter()
        for c in clients:
            c.shutdown()  # seals v4's open pack
        seal_s = time.perf_counter() - t0
    want = [["full"] * NRANKS] + [["delta"] * NRANKS] * (
        RECOVERY_VERSIONS - 1)
    if kinds != want:
        raise AssertionError(f"recovery: delta kinds {kinds}")
    with cluster._lock:
        packs = {v: cluster._packed.get((name, v))
                 for v in range(1, RECOVERY_VERSIONS + 1)}
    if not packs[RECOVERY_TARGET] or \
            packs[2] != packs[RECOVERY_TARGET] or \
            cluster.catalog_diagnostics:
        raise AssertionError(f"recovery: packs {packs}, catalog "
                             f"{cluster.catalog_diagnostics}")

    def all_tiers(cl):
        return list(cl.external_tiers) + \
            [t for ts in cl._node_tiers for t in ts]

    # (a) a fresh cluster restores through the catalog, listing nothing
    fresh = Cluster(vcfg, nranks=NRANKS)
    for t in all_tiers(fresh):
        t.keys_calls = 0
    gets0 = sum(t.get_calls for t in fresh.external_tiers)
    readers = [VelocClient(vcfg, fresh, rank=r) for r in range(NRANKS)]
    a_s = []
    try:
        for r, c in enumerate(readers):
            t0 = time.perf_counter()
            v, got = c.restart_latest(slots[r])
            _sync(torch)
            a_s.append(time.perf_counter() - t0)
            if v != RECOVERY_VERSIONS:
                raise AssertionError(f"(a) rank {r} restored v{v}: "
                                     f"{c.restart_diagnostics}")
            _assert_equal(torch, got, slots[r], f"(a) rank {r}")
    finally:
        for c in readers:
            c.shutdown()
    a_listings = sum(t.keys_calls for t in all_tiers(fresh))
    a_gets = sum(t.get_calls for t in fresh.external_tiers) - gets0
    if a_listings:
        raise AssertionError(f"(a) the catalog restart listed keys "
                             f"{a_listings} times")

    # (c) concurrent readers of the packed mid-chain version, external only
    ext = Cluster(vcfg, nranks=NRANKS)
    for ts in ext._node_tiers:
        for t in ts:
            t.wipe()
    counting = wrap_external_tiers(ext, CountingTier)
    barrier = threading.Barrier(RECOVERY_READERS)
    c_out = [None] * RECOVERY_READERS

    def reader(i):
        barrier.wait()
        t0 = time.perf_counter()
        try:
            regs = rst.load_rank_regions(ext, name, RECOVERY_TARGET,
                                         i % NRANKS)
            c_out[i] = (regs, time.perf_counter() - t0, None)
        except Exception as e:  # noqa: BLE001 — raised below
            c_out[i] = (None, time.perf_counter() - t0, e)

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(RECOVERY_READERS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    c_wall = time.perf_counter() - t0
    for i, (regs, _, err) in enumerate(c_out):
        if err is not None:
            raise AssertionError(f"(c) reader {i}: {err!r}")
        r = i % NRANKS
        _assert_equal(torch, tree_from_regions(slots[r], regs), kept[r],
                      f"(c) reader {i} (rank {r}) v{RECOVERY_TARGET}")
    blob_gets = {k: n for t in counting for k, n in t.get_counts.items()
                 if k in _blob_keys(fmt, name, t.get_counts)}
    if not blob_gets or max(blob_gets.values()) != 1 or \
            any(t.keys_calls for t in counting):
        raise AssertionError(f"(c) blob gets {blob_gets}, listings "
                             f"{[t.keys_calls for t in counting]}")
    c_s = [x[1] for x in c_out]
    del c_out, kept

    # (d) elastic restart: 4 ranks -> 2
    t0 = time.perf_counter()
    per_rank = rst.load_all_regions(fresh, name, RECOVERY_VERSIONS)
    halves = ring_slots(torch, leaves, 2)
    new = rst.elastic_regions(per_rank, 2)
    got = [tree_from_regions(halves[r], new[r]) for r in range(2)]
    _sync(torch)
    d_s = time.perf_counter() - t0
    for r in range(2):
        _assert_equal(torch, got[r], halves[r], f"(d) new rank {r} of 2")
    del per_rank, new, got

    # (e) rank 2 rebuilt from XOR parity; then (b) rank 0 from partners
    plan = rst.plan_restore(cluster, name)  # while the tiers are healthy
    cluster.fail_node(2)
    for t in cluster.node_tiers(3):
        for v in range(1, RECOVERY_VERSIONS + 1):
            t.delete(fmt.shard_key(name, v, 2) + ".partner")
    for ts in cluster._node_tiers:
        for t in ts:  # the peer copies of the sealed segments and packs
            for k in _blob_keys(fmt, name, t.keys()):
                t.delete(k)
    flaky = wrap_external_tiers(cluster,
                                lambda t: FlakyTier(t, fail_gets=True))
    with cluster._seg_lock:  # the writer's parsed external blobs go too
        cluster._segcache.clear()
    xor0 = ops.KERNEL_DISPATCHES["xor_reduce"]
    t0 = time.perf_counter()
    regs = rst.load_rank_regions(cluster, name, RECOVERY_VERSIONS, 2,
                                 plan=plan)
    got = tree_from_regions(slots[2], regs)
    _sync(torch)
    e_s = time.perf_counter() - t0
    e_xor = ops.KERNEL_DISPATCHES["xor_reduce"] - xor0
    _assert_equal(torch, got, slots[2], "(e) rank 2 from XOR parity")
    if e_xor < RECOVERY_VERSIONS:
        raise AssertionError(f"(e) {e_xor} XOR rebuilds for "
                             f"{RECOVERY_VERSIONS} links")
    e_failed = sum(len(f.failed_gets) for f in flaky)

    cluster.fail_node(0)
    for f in flaky:
        f.failed_gets.clear()
    gets0 = [f.inner.get_calls for f in flaky]
    t0 = time.perf_counter()
    regs = rst.load_rank_regions(cluster, name, RECOVERY_VERSIONS, 0,
                                 plan=plan)
    got = tree_from_regions(slots[0], regs)
    _sync(torch)
    b_s = time.perf_counter() - t0
    _assert_equal(torch, got, slots[0], "(b) rank 0 from partner copies")
    b_gets = sum(len(f.failed_gets) for f in flaky) + sum(
        f.inner.get_calls - g for f, g in zip(flaky, gets0))
    if b_gets:
        raise AssertionError(f"(b) {b_gets} external gets")
    del regs, got

    out = {
        "ranks_bytes": [sum(t.numel() * t.element_size() for t in s.values())
                        for s in slots],
        "versions": RECOVERY_VERSIONS, "write_s": write_s, "seal_s": seal_s,
        "packs": {str(v): k for v, k in packs.items()},
        "restart_s": {
            "a_catalog_fresh": a_s, "b_partner_l3_down": [b_s],
            "c_readers": c_s,
            "d_elastic_4_to_2": [d_s / 2, d_s / 2],
            "e_xor_rebuild": [e_s]},
        "c_wall_s": c_wall,
        "external_gets": {"a": a_gets, "b": b_gets,
                          "c": sum(sum(t.get_counts.values())
                                   for t in counting),
                          "c_blob_gets": sorted(blob_gets.values()),
                          "e_failed": e_failed},
        "listings": {"a": a_listings,
                     "c": sum(t.keys_calls for t in counting)},
        "e_xor_rebuilds": e_xor}
    print(f"recovery path: 4 ranks of {out['ranks_bytes']} bytes, v1 full, "
          f"v2-v{RECOVERY_VERSIONS} deltas, write "
          f"{[round(x, 3) for x in write_s]} s, seal {seal_s:.3f} s; (a) catalog restart per rank "
          f"{[round(x, 3) for x in a_s]} s, 0 listings; (b) from partners "
          f"{b_s:.3f} s, 0 external gets; (c) {RECOVERY_READERS} readers of "
          f"v{RECOVERY_TARGET} in {c_wall:.3f} s, one get per blob; (d) "
          f"elastic 4 -> 2 {d_s:.3f} s; (e) XOR rebuild {e_s:.3f} s; all "
          f"equal")
    return out


# |loss - reference loss| per step.  Every chip run so far measured a gap of
# exactly 0 between checkpointed and plain training, and the train path runs
# with deterministic algorithms; one step moves the loss by ~0.015.
TRAIN_LOSS_TOL = 1e-3


def _stats(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def disk_write_gbps(scratch: Path, nbytes: int = 256 << 20) -> float:
    """Write and fsync ``nbytes`` under ``scratch``, as the external file
    tier writes a shard; GB/s."""
    scratch.mkdir(parents=True, exist_ok=True)
    path = scratch / "disk_probe.bin"
    buf = os.urandom(1 << 20)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(nbytes >> 20):
            f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    dt = time.perf_counter() - t0
    path.unlink()
    return nbytes / dt / 1e9


def reference_train(torch, seed: int) -> dict:
    """Runs (a) and (b) of ``train_path`` replayed with the trainer's own
    parts (the initial state, the stream, the plain train step) and no
    checkpoint: steps 1-35, then from a copy of the state after step 30
    the batches of steps 36-50, as (a) goes on after its recovery and (b)
    after its resume.  Returns the losses of (a)'s and (b)'s steps and
    device copies of the state after steps 10, 20, 30, 40 and 50: what
    v10-v50 must hold."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.capture import snapshot_device
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = get_config("veloc-demo-100m")
    state = init_train_state(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    stream = SyntheticStream(cfg, ShapeCfg("cli", 256, 8, "train"),
                             seed=1234, device="cuda")
    step = make_train_step(cfg, lr=3e-4)
    losses, states = [], {}

    def train(state, batches):
        for i in batches:
            state, m = step(state, stream.batch(i))
            losses.append(float(m["loss"]))
            if (i + 1) % 10 == 0 and i + 1 not in states:
                states[i + 1] = snapshot_device(state).tree
        return state

    train(state, range(35))  # the live state is dropped at the failure
    state = train(snapshot_device(states[30]).tree, range(35, 50))
    return {"a": losses[:40], "b": losses[40:], "states": states}


def train_path(torch, scratch: Path, seed: int) -> dict:
    """Phase 7, the training workload: the port's trainer
    ``repro_torch.launch.train`` at the full width of veloc-demo-100m
    (83.1 M parameters, AdamW in f32, bf16 compute), batch 8 x 256 tokens,
    checkpointing every 10 steps through the one-rank async pipeline
    (serialize -> local -> flush).  Three runs, then a reference:

      a. 40 steps, a simulated failure after step 35, recovery from v30;
      b. ``--resume`` to step 50, which must resume from v40;
      c. the same 40 steps with ``--mode off``, the baseline rate;
      ref. (a) and (b) replayed without checkpoints (``reference_train``).

    Deterministic algorithms are on for the whole phase, so the runs and
    the reference must agree to the bit.  Checks: every loss finite and
    the last below the first in (a) and (c); every loss of (a), (b) and (c)
    within ``TRAIN_LOSS_TOL`` of the reference's at the same step; each of
    v10-v50, read back from the L3 files by a fresh client, equal byte for
    byte to the reference's state after that step, so no snapshot taken
    in the middle of (a) was overwritten by the next step's in-place
    update before the backend copied it; the state (a) recovered equal to
    v30, the state (b) resumed from equal to (a)'s last, the fresh
    client's ``restart_latest`` returning v50 equal to (b)'s last.  The
    rate of a run is its steps 2-N over the sum of their times (step 1
    holds the first use of each operator).  Then steps without and with
    checkpoints are profiled (``profile_train_steps``)."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core import restart as rst
    from repro_torch.core.capture import tree_from_regions
    from repro_torch.launch import train as trainer
    from repro_torch.models.model import model_flops

    disk_gbps = disk_write_gbps(scratch)
    common = ["--arch", "veloc-demo-100m", "--seq-len", "256", "--batch",
              "8", "--ckpt-every", "10", "--seed", str(seed),
              "--scratch", str(scratch)]
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        runs = {"a": trainer.main(common + ["--mode", "async", "--steps",
                                            "40", "--fail-at", "35"]),
                "b": trainer.main(common + ["--resume", "--steps", "50"]),
                "c": trainer.main(common + ["--mode", "off", "--steps",
                                            "40"])}
        gru_common = common[:-1] + [str(scratch / "gru")]
        runs["d"] = trainer.main(gru_common + [
            "--mode", "async", "--steps", "40", "--fail-at", "35",
            "--phase-predictor", "gru"])
        ref = reference_train(torch, seed)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    a, b, c, d = runs["a"], runs["b"], runs["c"], runs["d"]
    for k, r in runs.items():
        if not all(math.isfinite(x) for x in r.losses) or \
                (k != "b" and not r.losses[-1] < r.losses[0]):
            raise AssertionError(f"train run {k}: losses {r.losses}")
    if (a.recovered_version, b.resumed_from, d.recovered_version) != \
            (30, 40, 30):
        raise AssertionError(f"recovered v{a.recovered_version} and "
                             f"v{d.recovered_version}, resumed from "
                             f"v{b.resumed_from}; want v30, v30, v40")
    want = {"a": ref["a"], "b": ref["b"], "c": ref["a"][:35],
            "d": ref["a"]}
    gap = {k: max(abs(x - y) for x, y in zip(runs[k].losses, w))
           for k, w in want.items()}
    if len(a.losses) != 40 or len(b.losses) != 10 or \
            max(gap.values()) > TRAIN_LOSS_TOL:
        raise AssertionError(f"losses differ from the reference's by {gap}")

    fresh = trainer.VelocClient(
        trainer.make_pipeline(trainer.parse_args(common)),
        trainer.Cluster(trainer.TierTopology(scratch=str(scratch))))
    try:
        for v in (10, 20, 30, 40, 50):
            regs = rst.load_rank_regions(fresh.cluster, fresh.name, v, 0)
            _assert_tree_equal(torch, tree_from_regions(a.state, regs),
                               ref["states"][v], f"v{v} against the "
                               f"reference's state after step {v}")
        _assert_tree_equal(torch, a.recovered_state, ref["states"][30],
                           "state recovered at the failure")
        _assert_tree_equal(torch, b.resumed_state, a.state,
                           "state resumed in (b)")
        version, latest = fresh.restart_latest(a.state)
        if version != 50:  # run b wrote v50 over the same directory
            raise AssertionError(f"fresh client restored v{version}")
        _assert_tree_equal(torch, latest, b.state, "v50")
        shard_bytes = len(fresh.cluster.fetch_shard(fresh.name, 40, 0))
    finally:
        fresh.shutdown()
    # (d): the GRU gate only times the backend's work, so its checkpoints
    # and its recovered state are (a)'s, byte for byte
    fresh = trainer.VelocClient(
        trainer.make_pipeline(trainer.parse_args(gru_common)),
        trainer.Cluster(trainer.TierTopology(scratch=str(scratch / "gru"))))
    try:
        for v in (10, 20, 30, 40):
            regs = rst.load_rank_regions(fresh.cluster, fresh.name, v, 0)
            _assert_tree_equal(torch, tree_from_regions(d.state, regs),
                               ref["states"][v], f"(d) v{v} against the "
                               f"reference's state after step {v}")
        _assert_tree_equal(torch, d.recovered_state, ref["states"][30],
                           "(d) state recovered at the failure")
        _assert_tree_equal(torch, d.state, a.state, "(d) last state")
    finally:
        fresh.shutdown()
    del ref

    def rate(r):
        return (len(r.step_s) - 1) / sum(r.step_s[1:])

    flops = model_flops(get_config("veloc-demo-100m"),
                        trainer.ShapeCfg("cli", 256, 8, "train"))
    profile = profile_train_steps(torch, seed, scratch / "trace")
    out = {
        "step_ms_ckpt": {k: v * 1e3 for k, v in
                         _stats(a.step_s[1:]).items()},
        "step_ms_no_ckpt": {k: v * 1e3 for k, v in
                            _stats(c.step_s[1:]).items()},
        "step_ms_resumed": {k: v * 1e3 for k, v in
                            _stats(b.step_s[1:]).items()},
        "rate_steps_per_s": {"a": rate(a), "b": rate(b), "c": rate(c)},
        "ckpt_overhead": 1 - rate(a) / rate(c),
        "app_blocking_s": {"a": a.app_blocking_s, "b": b.app_blocking_s},
        "drain_s": {"a": a.drain_s, "b": b.drain_s},
        "restart_s": {"fail_at_v30": a.restart_s[0],
                      "resume_v40": b.restart_s[0]},
        "failure_wait_s": a.failure_wait_s,
        "disk_write_fsync_gbps": disk_gbps,
        "loss": {"a": [a.losses[0], a.losses[-1]],
                 "b": [b.losses[0], b.losses[-1]],
                 "c": [c.losses[0], c.losses[-1]],
                 "max_gap_to_reference": gap},
        "model_flops_per_step": flops,
        "model_tflops_no_ckpt": flops * rate(c) / 1e12,
        # device work of a plain step (profiled) over (c)'s median step
        "idle_share_no_ckpt": 1 - profile["plain"]["device_busy_ms_per_step"]
        / (statistics.median(c.step_s[1:]) * 1e3),
        "shard_bytes": shard_bytes,
        "step_ms_a": [x * 1e3 for x in a.step_s],
        "profile": profile,
    }
    out["gru"] = {
        "step_ms_gru": {k: v * 1e3 for k, v in _stats(d.step_s[1:]).items()},
        "step_ms_ema": out["step_ms_ckpt"],
        "overhead_gru": 1 - rate(d) / rate(c),
        "overhead_ema": out["ckpt_overhead"],
        "tick_host_ms_gru": {k: v * 1e3 for k, v in
                             _stats(d.tick_s[1:]).items()},
        "tick_host_ms_ema": {k: v * 1e3 for k, v in
                             _stats(a.tick_s[1:]).items()},
        "drain_s": {"gru": d.drain_s, "ema": a.drain_s},
        "failure_wait_s": {"gru": d.failure_wait_s, "ema": a.failure_wait_s},
        "restart_s": {"gru": d.restart_s[0], "ema": a.restart_s[0]},
        "app_blocking_s": d.app_blocking_s,
        "loss_gap_to_reference": gap["d"],
        "step_ms_d": [x * 1e3 for x in d.step_s],
        "card_vs_cpu": gru_gate_check(torch, d.step_s, seed)}
    print(f"train path: veloc-demo-100m at full width, batch 8 x 256; "
          f"median step {out['step_ms_no_ckpt']['median']:.2f} ms without "
          f"checkpoints, {out['step_ms_ckpt']['median']:.2f} ms with; "
          f"overhead {out['ckpt_overhead']:.4f}; v10-v50 equal to the "
          f"reference's states; recovered v30, resumed v40")
    return out


SHARDED_STEPS = 3


def _pfs_files(root: Path) -> dict:
    """{relative path: bytes} of every file under a checkpoint's external
    tier (shards, manifests)."""
    pfs = root / "pfs"
    return {str(f.relative_to(pfs)): f.read_bytes()
            for f in sorted(pfs.rglob("*")) if f.is_file()}


def _region_bytes(torch, a) -> bytes:
    """A restored region's bytes (a numpy array, or a bf16 tensor)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return a.tobytes()


def sharded_path(torch, scratch: Path, seed: int) -> dict:
    """Phase 7a, the sharded state path on the card: a one-rank NCCL
    process group (initialised through a file under ``scratch``, no port)
    and ``make_host_mesh(1, 1)`` on ``cuda``; veloc-demo-100m at full width
    with ``fsdp=True``, its train state resolved through
    ``resolve_tree(train_state_specs(cfg))`` and carried onto the mesh as
    DTensors (``distribute_tree``); batches 8 x 256 from
    ``SyntheticStream(mesh=)``.  With deterministic algorithms on (as the
    train path has them), ``SHARDED_STEPS`` sharded steps and as many
    plain steps from one initial state: every leaf's local tensor equal to
    the plain tensor bit for bit, and the losses too.  Then v1 of the
    sharded state through the default ``VelocConfig`` pipeline in sync
    mode; ``restart_latest(template, shardings=)`` must give DTensors on
    the same mesh with the same placements, bit-equal; and the sharded
    checkpoint's regions and external-tier files (shards and manifests)
    byte-identical to the plain state's checkpoint (on one rank every
    local shard is the whole leaf, so every region keeps its plain name).
    The group is destroyed at the end, so no later phase sees it; a failed
    NCCL or mesh initialisation fails the phase (no fallback)."""
    from collections import Counter

    import torch.distributed as dist

    from repro_torch import runtime, sharding
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import VelocClient, VelocConfig
    from repro_torch.core import restart as rst
    from repro_torch.core.capture import leaves_with_paths, snapshot_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         train_state_specs)

    t_phase = time.perf_counter()
    scratch.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("nccl", init_method="file://" + str(
        scratch / "pg_init"), rank=0, world_size=1)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        mesh = make_host_mesh(1, 1)
        backend = dist.get_backend()
        if mesh.device_type != "cuda" or backend != "nccl":
            raise AssertionError(f"mesh on {mesh.device_type}, backend "
                                 f"{backend}")
        cfg = get_config("veloc-demo-100m").replace(fsdp=True)
        shape = ShapeCfg("cli", 256, 8, "train")
        state = init_train_state(
            cfg, generator=torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        plain = snapshot_device(state).tree
        sh = sharding.resolve_tree(state, train_state_specs(cfg), mesh,
                                   cfg.fsdp)
        st = sharding.distribute_tree(state, sh)
        del state
        placed = Counter(str(tuple(t.placements))
                         for _, t in leaves_with_paths(st))
        print(f"sharded path: {sum(placed.values())} leaves by placement "
              f"{dict(placed)}")
        step = make_train_step(cfg)

        def run(state, batches, mesh_on):
            losses, ms = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with runtime.use_mesh(mesh if mesh_on else None):
                    state, m = step(state, b)
                loss = m["loss"].full_tensor() if mesh_on else m["loss"]
                losses.append(float(loss))  # waits for the device
                ms.append((time.perf_counter() - t0) * 1e3)
            return state, losses, ms

        sm = SyntheticStream(cfg, shape, seed=seed, mesh=mesh)
        sp = SyntheticStream(cfg, shape, seed=seed, device="cuda")
        st, s_loss, s_ms = run(st, [sm.batch(i) for i in
                                    range(SHARDED_STEPS)], True)
        plain, p_loss, p_ms = run(plain, [sp.batch(i) for i in
                                          range(SHARDED_STEPS)], False)
        if s_loss != p_loss:
            raise AssertionError(f"sharded losses {s_loss} != plain "
                                 f"{p_loss}")
        unequal = [n for (n, a), (_, b) in zip(leaves_with_paths(st),
                                               leaves_with_paths(plain))
                   if not torch.equal(a.to_local(), b)]
        if unequal:
            raise AssertionError(f"sharded steps differ from plain steps "
                                 f"at {len(unequal)} leaves: {unequal[:4]}")

        def ckpt(tree, where):
            client = VelocClient(VelocConfig(scratch=str(scratch / where),
                                             mode="sync"))
            t0 = time.perf_counter()
            fut = client.checkpoint(tree, version=1)
            blocking = time.perf_counter() - t0
            fut.result(timeout=120)  # raises the pipeline's error
            return client, blocking, fut.results.get("app_blocking_s")

        client, blocking_s, app_s = ckpt(st, "sharded")
        t0 = time.perf_counter()
        v, restored = client.restart_latest(st, shardings=sh)
        restore_s = time.perf_counter() - t0
        if v != 1:
            raise AssertionError(f"restored {v}: "
                                 f"{client.restart_diagnostics}")
        for (n, a), (_, b) in zip(leaves_with_paths(st),
                                  leaves_with_paths(restored)):
            if not isinstance(b, type(a)) or b.device_mesh is not mesh \
                    or b.placements != a.placements or \
                    not torch.equal(a.to_local(), b.to_local()):
                raise AssertionError(f"restored {n} differs")
        pclient, p_blocking_s, _ = ckpt(plain, "plain")
        regions = rst.load_rank_regions(client.cluster, "ckpt", 1, 0)
        p_regions = rst.load_rank_regions(pclient.cluster, "ckpt", 1, 0)
        if sorted(regions) != sorted(p_regions) or any("@" in k for k in
                                                       regions):
            raise AssertionError("sharded region names differ from plain")
        for k, a in regions.items():
            if _region_bytes(torch, a) != _region_bytes(torch, p_regions[k]):
                raise AssertionError(f"region {k} differs from plain")
        files, p_files = _pfs_files(scratch / "sharded"), \
            _pfs_files(scratch / "plain")
        if files != p_files:
            raise AssertionError(
                f"external-tier files differ: {sorted(files)} vs "
                f"{sorted(p_files)}")
        client.shutdown()
        pclient.shutdown()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        dist.destroy_process_group()
    out = {"config": {"arch": cfg.name, "fsdp": cfg.fsdp, "batch": [8, 256],
                      "mesh": {"data": 1, "model": 1},
                      "backend": backend, "steps": SHARDED_STEPS},
           "leaves_by_placement": dict(placed),
           "losses": s_loss, "bit_equal_to_plain": True,
           "step_ms_sharded": s_ms, "step_ms_plain": p_ms,
           "ckpt_blocking_s": blocking_s, "app_blocking_s": app_s,
           "plain_ckpt_blocking_s": p_blocking_s, "restore_s": restore_s,
           "regions": len(regions), "external_files": len(files),
           "checkpoint_bytes_identical": True,
           "phase_s": time.perf_counter() - t_phase}
    print(f"sharded path: {SHARDED_STEPS} sharded steps bit-equal to plain "
          f"steps; v1 restored as DTensors, {len(regions)} regions and "
          f"{len(files)} external files identical to the plain checkpoint")
    return out


# GRU phase gate, card against the plain CPU version: each tick from the
# same parameters, history and replay draws, both held against the same
# tick in float64 on the CPU.  Online SGD on step times with multi-second
# stalls can amplify f32 rounding within one tick, so the card passes when
# its largest error against float64 is at most GRU_ERR_RATIO times the CPU
# f32 version's, or below GRU_ERR_FLOOR (errors: |x - f64| / max(1, |f64|)
# of the normalised prediction).
GRU_ERR_RATIO = 10.0
GRU_ERR_FLOOR = 1e-5
# |card - CPU| of the interval MLP's efficiency after the same fit
INTERVAL_ABS_TOL = 1e-3


def gru_gate_check(torch, durations, seed: int, ticks: int = 300) -> dict:
    """The GRU phase gate on the card (its CUDA graphs on its own stream)
    against the plain CPU version, fed the same stream: ``durations`` (the
    step times of train run (d)) cycled to ``ticks`` steps, past the
    256-deep history.  Before each tick the CPU copies, one in float32 and
    one in float64, take the card's parameters, so all three tick from the
    same state; each tick's prediction is held as ``GRU_ERR_RATIO`` says.
    Also reported, not held: the gap to a float32 CPU copy left to run free
    from the same first parameters, where rounding compounds from tick to
    tick.  The card's ``tick("step_end")`` host time is taken alone,
    without the read (the loop never waits for the prediction); the device
    time of one full tick's graph is timed with CUDA events."""
    from repro_torch.core.phases import GRUPhasePredictor
    from repro_torch.train.steps import gru_params_from_numpy

    def params(p):
        return {k: t.detach().cpu().numpy() for k, t in p.params.items()}

    def err(x, ref):
        return abs(x - ref) / max(1.0, abs(ref))

    card = GRUPhasePredictor(seed=seed, device="cuda", clock=lambda: 0.0)
    cpu = GRUPhasePredictor(seed=seed, device="cpu", clock=lambda: 0.0)
    f64 = GRUPhasePredictor(seed=seed, device="cpu", clock=lambda: 0.0)
    with torch.no_grad():  # float64 parameters and learning rate
        for p in f64.params.values():
            p.data = p.data.double()
        f64._lr = f64._lr.double()
    free = GRUPhasePredictor(seed=seed, device="cpu", clock=lambda: 0.0)
    gru_params_from_numpy(free, params(card))
    card_err = cpu_err = card_cpu = free_gap = 0.0
    t, tick_s, cpu_s = 0.0, [], []
    for i in range(ticks):
        dur = float(durations[i % len(durations)])
        start = params(card)
        gru_params_from_numpy(cpu, start)
        with torch.no_grad():
            for k, p in f64.params.items():
                p.copy_(torch.from_numpy(start[k]))
        for p in (card, cpu, f64, free):
            p.tick("step_begin", t)
        t0 = time.perf_counter()
        card.tick("step_end", t + dur)
        tick_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cpu.tick("step_end", t + dur)
        cpu_s.append(time.perf_counter() - t0)
        for p in (f64, free):
            p.tick("step_end", t + dur)
        if card._pred is not None:
            a, b, ref = (p._pred.value() for p in (card, cpu, f64))
            card_err = max(card_err, err(a, ref))
            cpu_err = max(cpu_err, err(b, ref))
            card_cpu = max(card_cpu, err(a, b))
        a, b = card.predict_next_duration(), free.predict_next_duration()
        free_gap = max(free_gap, abs(a - b) / abs(b))
        t += dur + 0.001
    if not card_err <= max(GRU_ERR_FLOOR, GRU_ERR_RATIO * cpu_err):
        raise AssertionError(f"GRU gate: card error {card_err} against "
                             f"float64, CPU float32's {cpu_err}")
    # device time of one full tick's graph (the SGD steps of 1 + replay
    # windows, then the prediction) on the predictor's stream
    graph = card._graphs[1 + card.replay][0]
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.stream(card._stream):
        e0.record()
        for _ in range(20):
            graph.replay()
        e1.record()
    torch.cuda.synchronize()
    trained = [x for i, x in enumerate(tick_s) if i >= card.window]
    cpu_trained = [x for i, x in enumerate(cpu_s) if i >= cpu.window]
    return {"ticks": ticks, "max_err_card_vs_f64": card_err,
            "max_err_cpu_f32_vs_f64": cpu_err, "max_gap_card_vs_cpu":
            card_cpu, "ratio": GRU_ERR_RATIO, "floor": GRU_ERR_FLOOR,
            "max_rel_gap_free_running": free_gap,
            "tick_graph_device_ms": e0.elapsed_time(e1) / 20,
            "tick_host_ms_card": {k: v * 1e3 for k, v in
                                  _stats(trained).items()},
            "tick_host_ms_cpu_eager": {k: v * 1e3 for k, v in
                                       _stats(cpu_trained).items()}}


def interval_check(torch, seed: int) -> dict:
    """``MLIntervalOptimizer`` fitted on the card (500 epochs on simulator
    samples of 10 scenarios x 8 intervals, as the JAX package's test and
    benchmark fit it) against the plain CPU fit from the same parameters
    and epoch permutations; its best interval for a held-out scenario
    beside the simulator's best on the same grid and Young/Daly."""
    import math

    import numpy as np

    from repro_torch.core.interval import (KNNIntervalBaseline, LevelCfg,
                                           MLIntervalOptimizer,
                                           MultiLevelSimulator, ScenarioCfg,
                                           young_daly)
    from repro_torch.train.steps import interval_params_from_numpy

    def scenario(mtbf):
        return ScenarioCfg(levels=[
            LevelCfg("L1", write_s=2.0, blocking_frac=1.0, mtbf_s=mtbf,
                     recovery_s=30.0),
            LevelCfg("L3", write_s=60.0, blocking_frac=0.05,
                     mtbf_s=mtbf * 8, recovery_s=300.0)])

    rng = np.random.default_rng(seed)
    samples = []
    t0 = time.perf_counter()
    for _ in range(10):
        sc = scenario(float(rng.uniform(3_000, 60_000)))
        sim = MultiLevelSimulator(sc, horizon_s=60_000,
                                  seed=int(rng.integers(1e6)))
        for iv in np.geomspace(60, 15_000, 8):
            samples.append((sc, float(iv), sim.efficiency(iv, trials=4)))
    sample_s = time.perf_counter() - t0
    card = MLIntervalOptimizer(hidden=48, seed=seed, device="cuda")
    cpu = MLIntervalOptimizer(hidden=48, seed=seed, device="cpu")
    interval_params_from_numpy(cpu, {k: p.detach().cpu().numpy()
                                     for k, p in card.params.items()})
    t0 = time.perf_counter()
    loss = card.fit(samples, epochs=500, lr=5e-3)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_loss = cpu.fit(samples, epochs=500, lr=5e-3)
    cpu_fit_s = time.perf_counter() - t0
    sc = scenario(17_000.0)
    grid = np.geomspace(60, 15_000, 16)
    a = np.array([card.predict_eff(sc, g) for g in grid])
    b = np.array([cpu.predict_eff(sc, g) for g in grid])
    gap = float(np.abs(a - b).max())
    if not gap <= INTERVAL_ABS_TOL:
        raise AssertionError(f"interval MLP: card vs CPU gap {gap}")
    top2 = np.sort(b)[-2:]
    best = card.best_interval(sc, grid=grid)
    if top2[1] - top2[0] > INTERVAL_ABS_TOL and \
            best != cpu.best_interval(sc, grid=grid):
        raise AssertionError("interval MLP: card and CPU pick other points")
    sim = MultiLevelSimulator(sc, horizon_s=60_000, seed=99)
    truth, truth_eff = sim.best_interval(grid=grid, trials=6)
    knn = KNNIntervalBaseline(k=3)
    knn.fit(samples)
    cost = sum(lv.write_s * lv.blocking_frac for lv in sc.levels)
    mtbf = 1 / sum(1 / lv.mtbf_s for lv in sc.levels)
    yd = young_daly(cost, mtbf)
    out = {"samples": len(samples), "sample_s": sample_s, "fit_s": fit_s,
           "cpu_fit_s": cpu_fit_s, "loss": loss, "cpu_loss": cpu_loss,
           "max_abs_gap": gap, "tol": INTERVAL_ABS_TOL,
           "best_interval_s": {"ml": best, "simulator": float(truth),
                               "knn": knn.best_interval(sc, grid=grid),
                               "young_daly": yd},
           "efficiency": {"ml": sim.efficiency(best, trials=6),
                          "simulator": truth_eff,
                          "young_daly": sim.efficiency(yd, trials=6)}}
    if not all(math.isfinite(x) for x in out["efficiency"].values()):
        raise AssertionError(f"interval: {out['efficiency']}")
    return out


def profile_train_steps(torch, seed: int, scratch: Path,
                        steps: int = 5, ckpt_steps: int = 12) -> dict:
    """Where a train step's time goes, under ``torch.profiler`` at the
    trainer's shape, after two warm-up steps:

      plain: ``steps`` steps without checkpoints: wall time per step and
        the device's idle share, both under the profiler (which slows the
        host; ``train_path`` gives the idle share against an unprofiled
        step), device busy time per step (the union of kernels and copies)
        and the kernels launched per step;
      ckpt: ``ckpt_steps`` steps with the fused capture and an async
        checkpoint (the trainer's one-rank pipeline) after every fourth,
        so versions queue up as in run (a): per step, its length, the
        calling thread's time in operators and between them, its CUDA
        runtime calls by name and the backend threads' pageable copies
        (``blocking_breakdown``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import train as trainer
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = get_config("veloc-demo-100m")
    state = init_train_state(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    stream = SyntheticStream(cfg, ShapeCfg("cli", 256, 8, "train"))
    step = make_train_step(cfg)
    for i in range(2):
        float(step(state, stream.batch(i))[1]["loss"])
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        with record_function("train steps"):
            t0 = time.perf_counter()
            for i in range(steps):
                float(step(state, stream.batch(2 + i))[1]["loss"])
            wall = time.perf_counter() - t0
    scratch.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(scratch / "train_steps.json.gz"))
    events = _load_trace(scratch / "train_steps.json.gz")
    dev = device_time(events)
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    out = {"plain": {
        "steps": steps, "wall_ms_per_step_profiled": wall / steps * 1e3,
        "device_busy_ms_per_step": dev["busy_ms"] / steps,
        "idle_share_profiled": dev["idle_share"],
        "kernels_per_step": kernels / steps,
        "device_ms_by_kind_per_step": {
            k: v / steps for k, v in dev["ms_by_kind"].items()}}}

    args = trainer.parse_args(["--scratch", str(scratch / "ckpt")])
    client = trainer.VelocClient(trainer.make_pipeline(args), trainer.Cluster(
        trainer.TierTopology(scratch=args.scratch)))
    step = make_train_step(cfg, capture=True)
    try:
        with profile(activities=activities) as prof:
            for i in range(ckpt_steps):
                with record_function(f"step {i}"):
                    state, snap, m = step(state, stream.batch(10 + i))
                    float(m["loss"])
                    if i % 4 == 1:
                        client.checkpoint(state, version=i, snap=snap)
        if not client.wait(timeout=300):
            raise AssertionError("profiled checkpoints did not drain")
    finally:
        client.shutdown()
    prof.export_chrome_trace(str(scratch / "ckpt_steps.json.gz"))
    events = _load_trace(scratch / "ckpt_steps.json.gz")
    out["ckpt"] = blocking_breakdown(events, [f"step {i}"
                                              for i in range(ckpt_steps)])
    return out


# ---------------------------------------------------------------------------
# the recurrent family: xlstm-1.3b and recurrentgemma-2b at full width
# ---------------------------------------------------------------------------

#: the f32 form's error against a float64 run of the reference form may be
#: at most this many times the f32 reference form's own
SCAN_ERR_RATIO = 10.0
#: the xlstm train path: steps, a checkpoint every XLSTM_EVERY steps, the
#: simulated failure after step XLSTM_FAIL (recovery from the version before)
XLSTM_STEPS, XLSTM_EVERY, XLSTM_FAIL = 4, 2, 3
#: ``--capture standalone --keep-versions 1``: ``xlstm_train_path`` says
#: why.  Depth cut to 24 of 48 layers (3 of 6 groups of its pattern) to
#: keep the whole script under 1,000 s with the MoE lines (PERF.md §4)
XLSTM_LAYERS = 24
XLSTM_PATH = {"arch": "xlstm-1.3b", "seq_len": 256, "batch": 8,
              "layers": XLSTM_LAYERS,
              "steps": XLSTM_STEPS, "every": XLSTM_EVERY, "fail": XLSTM_FAIL,
              "flags": ["--capture", "standalone", "--keep-versions", "1"]}
#: the decode checks: prompt tokens, decode steps and rows, and the
#: tolerance (rtol and atol) of tests/test_recurrent_equiv.py
DECODE_PROMPT, DECODE_STEPS, DECODE_ROWS = 240, 16, 2
DECODE_TOL = 3e-2
#: the float64 decode rows against the float64 forward
F64_TOL = 1e-6
#: recurrentgemma-2b cut to one period of its pattern (rglru, rglru,
#: local_attn) at full width and vocabulary: layers, steps, parameters
RG_LAYERS, RG_STEPS, RG_PARAMS = 3, 10, 1_567_680_000


def _rel_err(x, ref) -> float:
    """max |x - ref| over max |ref| (ref float64)."""
    return float((x.double() - ref).abs().max() / ref.abs().max())


def recurrent_scans(torch, seed: int) -> dict:
    """The two recurrences at full-width shapes, each f32 form and its f32
    reference form held against a float64 run of the reference form on the
    card: ``mlstm_chunkwise`` against ``mlstm_recurrent`` at xlstm-1.3b's
    (B 8, T 256, H 4, head dim 1024; the tests' gate distributions), and
    the log-depth ``linear_scan`` against ``linear_scan_loop`` at
    recurrentgemma-2b's (B 8, T 256, width 2560; a from the RG-LRU gate's
    formula over its initial lambda range).  The f32 form passes when its
    error is at most ``SCAN_ERR_RATIO`` times the f32 reference's."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import recurrent as R

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = get_config("xlstm-1.3b")
    B, T, H = 8, 256, cfg.num_heads
    hd = 2 * cfg.d_model // H
    q, k, v = (torch.randn((B, T, H, hd), generator=gen, device="cuda")
               for _ in range(3))
    log_i = torch.randn((B, T, H), generator=gen, device="cuda") - 1.0
    log_f = -torch.randn((B, T, H), generator=gen, device="cuda").abs() * 0.1
    carry64 = tuple(t.double() for t in R.mlstm_carry_init(cfg, B, "cuda"))
    ref = R.mlstm_recurrent(q, k, v, log_i, log_f, carry64)[0]
    out = {"mlstm": {
        "shape": [B, T, H, hd],
        "err_chunkwise_f32": _rel_err(
            R.mlstm_chunkwise(q, k, v, log_i, log_f)[0], ref),
        "err_recurrent_f32": _rel_err(
            R.mlstm_recurrent(q, k, v, log_i, log_f)[0], ref),
        "ms_chunkwise": _cuda_ms(
            torch, lambda: R.mlstm_chunkwise(q, k, v, log_i, log_f), reps=5),
        "ms_recurrent": _cuda_ms(
            torch, lambda: R.mlstm_recurrent(q, k, v, log_i, log_f), reps=2,
            warmup=1)}}
    del q, k, v, ref, carry64
    rg = get_config("recurrentgemma-2b")
    w = rg.lru_width
    lam = torch.rand((w,), generator=gen, device="cuda") * 2.3 - 4.3
    r = torch.rand((B, T, w), generator=gen, device="cuda")
    a = torch.exp(-R.RGLRU_C * F.softplus(lam) * r)
    b = torch.sqrt(1.0 - a * a) * torch.randn((B, T, w), generator=gen,
                                              device="cuda")
    ref = R.linear_scan_loop(a.double(), b.double())
    out["rglru"] = {
        "shape": [B, T, w],
        "err_scan_f32": _rel_err(R.linear_scan(a, b), ref),
        "err_loop_f32": _rel_err(R.linear_scan_loop(a, b), ref),
        "ms_scan": _cuda_ms(torch, lambda: R.linear_scan(a, b), reps=5),
        "ms_loop": _cuda_ms(torch, lambda: R.linear_scan_loop(a, b),
                            reps=2, warmup=1)}
    for name, fast, slow in (("mlstm", "err_chunkwise_f32",
                              "err_recurrent_f32"),
                             ("rglru", "err_scan_f32", "err_loop_f32")):
        o = out[name]
        if not o[fast] <= SCAN_ERR_RATIO * o[slow]:
            raise AssertionError(f"{name}: f32 error {o[fast]} against "
                                 f"float64 exceeds {SCAN_ERR_RATIO} x the "
                                 f"reference form's {o[slow]}")
    return out


def state_tables(torch, tree) -> dict:
    """Per leaf of ``tree`` (tensors on the card, or host arrays), the
    (rows, 2) Fletcher table of its bytes, computed on the card by the
    port's checksum kernel (``ops.fletcher_chunks``): 1/1024 of the bytes
    stand for a 22 GB state."""
    from repro_torch.core.capture import leaves_with_paths
    from repro_torch.kernels import ops

    return {name: ops.fletcher_chunks(leaf)
            for name, leaf in leaves_with_paths(tree)}


def _assert_tables_equal(got: dict, want: dict, what: str):
    import numpy as np

    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: leaf names differ")
    for k, t in want.items():
        if not np.array_equal(got[k], t):
            raise AssertionError(f"{what}: leaf {k!r} differs")


class MemorySampler:
    """A thread that reads ``torch.cuda.memory_allocated()`` every
    ``period`` seconds, each reading beside ``time.monotonic()``."""

    def __init__(self, torch, period: float = 0.05):
        import threading

        self.samples: list = []
        self._stop = threading.Event()

        def run():
            while not self._stop.wait(period):
                self.samples.append((time.monotonic(),
                                     torch.cuda.memory_allocated()))

        self._thread = threading.Thread(target=run, name="memory-sampler",
                                        daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def snapshot_release(samples: list, results: dict, state_bytes: int,
                     t_call: float | None = None) -> dict:
    """When the backend dropped a standalone checkpoint's device snapshot:
    the first reading after the call at which the allocated bytes fell by
    at least half the state at once (a step frees at most its gradients,
    a third of it), beside the end of the device-to-host copy and of the
    L3 flush, all in seconds after the call (``t_call`` on the monotonic
    clock; by default the first stage's end, the trainer's interval
    stage)."""
    if t_call is None:
        t_call = min(v for k, v in results.items()
                     if k.endswith(".done_at"))
    released = None
    for (_, before), (t, after) in zip(samples, samples[1:]):
        if t > t_call and before - after >= state_bytes // 2:
            released = t
            break
    flush = results.get("l3-flush.done_at")
    out = {"released_s": None if released is None else released - t_call,
           "d2h_done_s": results["d2h_done_at"] - t_call,
           "flush_done_s": None if flush is None else flush - t_call}
    if released is None or (flush is not None and released >= flush):
        raise AssertionError(f"device snapshot not released before the L3 "
                             f"flush ended: {out}")
    return out


def _host_memory() -> dict:
    """This process's resident set now and at its peak, GiB."""
    import resource

    rss = None
    for line in Path("/proc/self/status").read_text().splitlines():
        key, _, val = line.partition(":")
        if key == "VmRSS":
            rss = int(val.split()[0]) / 2**20
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return {"rss_gib": rss, "peak_rss_gib": peak}


def _profile_step(torch, fn, trace: Path) -> dict:
    """One call of ``fn`` (a train step ending in a read of its loss) under
    ``torch.profiler`` (device activity only): kernels launched, device
    busy ms (the union of kernels and copies), the profiled wall ms, and
    the kernels that took the most device time (name, ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    gpu = [e for e in _load_trace(trace)
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    trace.unlink()
    busy, last = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu):
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    by_name = {}
    for e in gpu:
        t = by_name.setdefault(e["name"][:80], [0.0, 0])
        t[0] += e["dur"] / 1e3
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    return {"kernels": sum(1 for e in gpu if e["cat"] == "kernel"),
            "device_busy_ms": busy / 1e3, "wall_ms_profiled": wall * 1e3,
            "top": [[name, ms, n] for name, (ms, n) in top]}


def path_config(path: dict):
    """A train path's config: its arch, cut to ``path["layers"]`` when
    given."""
    from repro_torch.configs import get_config

    cfg = get_config(path["arch"])
    if "layers" in path:
        cfg = cfg.replace(num_layers=path["layers"])
    return cfg


def replay_reference(torch, path: dict, seed: int, trace: Path) -> dict:
    """A train path's run (``path``: one of ``XLSTM_PATH``,
    ``WHISPER_PATH``) replayed with the trainer's own parts and no
    checkpoint: steps 1 to ``fail``, then from a device copy of the state
    after step r (the version the failure recovers) the batches of the
    steps after the failure, as the trainer goes on after its recovery.
    Returns the losses in the run's order, the step times (the first holds
    each operator's first use; the step after the failure is profiled,
    ``_profile_step``) and, per checkpointed step, the state's per-leaf
    tables (``state_tables``): what each version must hold."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.capture import snapshot_device
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = path_config(path)
    steps, every, fail = path["steps"], path["every"], path["fail"]
    state = init_train_state(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    stream = SyntheticStream(
        cfg, ShapeCfg("cli", path["seq_len"], path["batch"], "train"),
        seed=1234, device="cuda")
    step = make_train_step(cfg, lr=3e-4)
    r = fail - fail % every
    out = {"losses": [], "step_s": [], "tables": {}}
    kept = None

    def one(state, i):
        t0 = time.perf_counter()
        state, m = step(state, stream.batch(i))
        out["losses"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t0)
        return state

    for i in range(fail):
        if i == fail - 1:  # the step the failure throws away
            out["profile"] = _profile_step(
                torch, lambda: one(state, i), trace)
            out["step_s"].pop()
        else:
            state = one(state, i)
        if (i + 1) % every == 0:
            out["tables"][i + 1] = state_tables(torch, state)
        if i + 1 == r:
            kept = snapshot_device(state).tree
    state = kept
    del kept
    for i in range(fail, steps):
        state = one(state, i)
        if (i + 1) % every == 0:
            out["tables"][i + 1] = state_tables(torch, state)
    out["recovered"] = r
    return out


def trainer_run(torch, path: dict, scratch: Path, seed: int) -> dict:
    """The trainer ``repro_torch.launch.train`` on a train path's config
    (``path_config``: its arch at full width, cut in depth where the path
    says so), its batch, a checkpoint every ``every`` steps through the
    one-rank async pipeline, the simulated failure after ``fail`` and
    recovery, with the path's capture flags; the device memory sampled
    throughout."""
    from unittest import mock

    from repro_torch.launch import train as trainer

    build = trainer.build

    def cut_build(*args):
        return path_config(path), build(*args)[1]

    common = ["--arch", path["arch"], "--seq-len", str(path["seq_len"]),
              "--batch", str(path["batch"]),
              "--ckpt-every", str(path["every"]), "--seed", str(seed),
              "--scratch", str(scratch)] + path["flags"]
    torch.cuda.reset_peak_memory_stats()
    with MemorySampler(torch) as mem, \
            mock.patch.object(trainer, "build", cut_build):
        run = trainer.main(common + ["--mode", "async", "--steps",
                                     str(path["steps"]), "--fail-at",
                                     str(path["fail"])])
    return {"run": run, "args": common, "samples": mem.samples,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "host": _host_memory()}


def fresh_restart(torch, scratch: Path, args: list, template) -> tuple:
    """A fresh client over the same scratch directory (only the persistent
    tiers survive): ``restart_latest`` onto the card."""
    from repro_torch.launch import train as trainer

    fresh = trainer.VelocClient(
        trainer.make_pipeline(trainer.parse_args(args)),
        trainer.Cluster(trainer.TierTopology(scratch=str(scratch))))
    try:
        t0 = time.perf_counter()
        version, latest = fresh.restart_latest(template)
        torch.cuda.synchronize()
        return version, latest, time.perf_counter() - t0
    finally:
        fresh.shutdown()


def _prefill_decode(torch, cfg, params, tokens, prompt: int,
                    extra: dict) -> tuple:
    """The prefill's last logits and each decoded token's, (B, 1 + steps,
    V), and the host ms of the prefill and of each decode step.  The
    prefill takes ``prompt`` tokens and ``extra`` (the stub frontends'
    frames or patches); its self-attention caches are sized for the whole
    context (the encoder-decoder's for ``dec_max_len``), and decode
    positions count the patches first."""
    from repro_torch.models.model import make_decode_fn, make_prefill_fn

    P = extra["patches"].shape[1] if "patches" in extra else 0
    S = tokens.shape[1]
    cache_len = cfg.dec_max_len if cfg.is_encoder_decoder else P + S
    decode = make_decode_fn(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = make_prefill_fn(cfg, cache_len=cache_len)(
        params, {"tokens": tokens[:, :prompt], **extra})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    rows, step_ms = [last], []
    for pos in range(prompt, S):
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, tokens[:, pos:pos + 1], P + pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(lg)
    return torch.stack(rows, dim=1), prefill_ms, step_ms


def _forward_rows(cfg, params, tokens, prompt: int, extra: dict):
    """The forward pass's logits at the text positions from ``prompt - 1``
    on: ``lm_forward`` (after the patches), or the encoder-decoder's
    teacher-forced ``decode_train`` on the encoded frames."""
    from repro_torch.models.encdec import decode_train, encode
    from repro_torch.models.transformer import lm_forward

    if cfg.is_encoder_decoder:
        full = decode_train(params, cfg, tokens,
                            encode(params, cfg, extra["frames"]))
    else:
        full = lm_forward(params, cfg, tokens,
                          extra_embeds=extra.get("patches"))
        full = full[:, full.shape[1] - tokens.shape[1]:]
    return full[:, prompt - 1:]


def cut_depth(cfg, params, n: int) -> tuple:
    """``cfg`` and ``params`` cut to the first ``n`` layers of each stack
    (the encoder-decoder's two, or a one-kind decoder's), at full width."""
    from repro_torch.core.capture import map_tree

    def first(tree):
        return map_tree(lambda _, t: t[:n], tree)

    if cfg.is_encoder_decoder:
        return cfg.replace(num_layers=n, enc_layers=n), dict(
            params, enc_blocks=first(params["enc_blocks"]),
            dec_blocks=first(params["dec_blocks"]))
    if len(cfg.block_pattern) != 1:
        raise ValueError(f"cannot cut the pattern {cfg.block_pattern}")
    return cfg.replace(num_layers=n), dict(
        params, blocks=first(params["blocks"]), rem=())


def on_card(cfg, params, f64_layers: int | None = None):
    """``decode_check``'s ``build`` for ``params`` already on the card:
    ``cfg`` and ``params`` as they are for float32; for float64 cut to
    ``f64_layers`` layers a stack when given and cast."""
    from repro_torch.core.capture import map_tree

    def build(dtype: str) -> tuple:
        if dtype == "float32":
            return cfg, params
        c, p = cut_depth(cfg, params, f64_layers) if f64_layers else \
            (cfg, params)
        return c, map_tree(lambda _, t: t.double(), p)
    return build


def decode_check(torch, cfg, build, seed: int, *, prompt=DECODE_PROMPT,
                 f32_tol: float | None = None) -> dict:
    """Prefill of ``prompt`` tokens (with the stub frontends' frames or
    patches, drawn on the card) into caches sized for the whole context,
    then ``DECODE_STEPS`` decode steps: each row (the prefill's last
    logits, then each decoded token's) against the forward pass's logits
    at that position (``_forward_rows``).  Run in f32 compute and in
    float64, each on what ``build(dtype)`` gives, a config of ``cfg``'s
    width and the parameters in that dtype on the card (``on_card``, or
    parameters drawn anew for each run, so that one copy exists at a
    time).  The float64 rows are held within ``F64_TOL``.  The f32 rows
    are held within ``f32_tol`` when given; else within ``DECODE_TOL``
    (the JAX test's rtol and atol) where the f32 forward itself lies
    within ``DECODE_TOL`` of the float64 forward of the same depth.  Past
    that, rounding amplified through a deep stack, not prefill or decode,
    decides the f32 gap (PERF.md §6), and it is reported only."""
    from repro_torch.models.layers import torch_dtype

    S = prompt + DECODE_STEPS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (DECODE_ROWS, S),
                           generator=gen, device="cuda", dtype=torch.int32)
    extra32 = {}
    if cfg.is_encoder_decoder:
        extra32["frames"] = torch.randn(
            (DECODE_ROWS, WHISPER_FRAMES, cfg.d_model), generator=gen,
            device="cuda") * 0.02
    elif cfg.frontend == "vision":
        extra32["patches"] = torch.randn(
            (DECODE_ROWS, cfg.num_patches, cfg.d_model), generator=gen,
            device="cuda") * 0.02
    V = cfg.vocab_size  # the padded vocab's columns are masked to -1e30
    out = {"prompt": prompt, "steps": DECODE_STEPS, "rows": DECODE_ROWS,
           "extra": {k: list(v.shape) for k, v in extra32.items()},
           "f32_tol": f32_tol, "f64_tol": F64_TOL}
    fwd = {}
    with torch.no_grad():
        for name, dt in (("f32", "float32"), ("f64", "float64")):
            c, p = build(dt)
            c = c.replace(compute_dtype=dt)
            if dt == "float64":
                out["f64_layers"] = c.num_layers
            extra = {k: v.to(torch_dtype(dt)) for k, v in extra32.items()}
            full = _forward_rows(c, p, tokens, prompt, extra)[..., :V]
            rows, prefill_ms, step_ms = _prefill_decode(torch, c, p, tokens,
                                                        prompt, extra)
            rows = rows[..., :V]
            del p
            fwd[name] = full
            tol = F64_TOL if dt == "float64" else (f32_tol or DECODE_TOL)
            out[name] = {
                "finite": bool(torch.isfinite(rows).all()),
                "gap": float((rows - full).abs().max()),
                "gap_per_row": (rows - full).abs().amax(dim=(0, 2)).tolist(),
                "within_tol": bool(torch.allclose(rows, full, rtol=tol,
                                                  atol=tol)),
                "prefill_ms": prefill_ms,
                "decode_ms_per_step": _stats(step_ms)}
    out["logit_absmax"] = float(fwd["f32"].abs().max())
    if f32_tol is None:
        out["forward_f32_vs_f64"] = float(
            (fwd["f32"].double() - fwd["f64"]).abs().max())
        out["f32_held"] = out["forward_f32_vs_f64"] <= DECODE_TOL
    else:
        out["f32_held"] = True
    out["ok"] = out["f32"]["finite"] and out["f64"]["finite"] and \
        out["f64"]["within_tol"] and (out["f32"]["within_tol"]
                                      or not out["f32_held"])
    return out


def checked_train_path(torch, path: dict, scratch: Path, seed: int,
                       run_path, name: str, *, want_version=None,
                       keep_live=False) -> tuple:
    """A train path (``path``: ``XLSTM_PATH`` or ``WHISPER_PATH``) at full
    width (``path_config``), checked against its replay:

      ref. ``replay_reference``: the run replayed without checkpoints, per
        checkpointed step the state's per-leaf tables (a state of many GB
        cannot be kept as device copies), its step times (the baseline
        rate) and a profiled step;
      a. ``trainer_run``: the trainer with checkpoints, the failure and
        recovery;
      restart. a fresh client's ``restart_latest`` from the persistent
        tiers (``want_version`` when given, else the newest version the
        flush completed), and every other version read back by it.

    Deterministic algorithms are on for the replay and the run, so every
    checked state equals the replay's byte for byte: each version read back
    by the fresh client, the state recovered at the failure and the last
    state, held by tables computed on the card (``state_tables``), and the
    losses within ``TRAIN_LOSS_TOL``.  ``run_path`` counts the kernels of
    the run and of the fresh restart.  Returns the path's line (every key
    but ``config``), the run (its state dropped unless ``keep_live``), the
    fresh client's state and the device memory samples."""
    import gc
    import math
    import warnings

    from repro_torch.core import restart as rst
    from repro_torch.core.capture import leaves_with_paths
    from repro_torch.launch import train as trainer

    steps = path["steps"]
    scratch.mkdir(parents=True, exist_ok=True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    marks = [("start", time.perf_counter())]
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ref = replay_reference(torch, path, seed,
                                   scratch / "trace.json.gz")
            marks.append(("replay", time.perf_counter()))
            gc.collect()
            torch.cuda.empty_cache()
            a, launches_run = run_path(
                f"{name} train path", ("checksum",),
                lambda: trainer_run(torch, path, scratch, seed))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    run = a.pop("run")
    marks.append(("run", time.perf_counter()))
    gc.collect()
    r = ref["recovered"]
    if run.recovered_version != r:
        raise AssertionError(f"recovered v{run.recovered_version}, want v{r}")
    gap = max(abs(x - y) for x, y in zip(run.losses, ref["losses"]))
    if len(run.losses) != steps or \
            not all(math.isfinite(x) for x in run.losses) or \
            gap > TRAIN_LOSS_TOL:
        raise AssertionError(f"{name} losses {run.losses} against the "
                             f"replay's {ref['losses']}")
    _assert_tables_equal(state_tables(torch, run.recovered_state),
                         ref["tables"][r], f"state recovered at v{r}")
    run.recovered_state = None
    _assert_tables_equal(state_tables(torch, run.state),
                         ref["tables"][steps], "last state")
    sizes = [t.numel() * t.element_size()
             for _, t in leaves_with_paths(run.state)]
    marks.append(("state checks", time.perf_counter()))
    gc.collect()
    torch.cuda.empty_cache()
    (version, latest, restart_s), launches_restart = run_path(
        f"{name} fresh restart", ("checksum",),
        lambda: fresh_restart(torch, scratch, a["args"], run.state))
    if not keep_live:
        run.state = None
    marks.append(("fresh restart", time.perf_counter()))
    # without want_version: the newest version the flush completed, the
    # one before when the last one's flush outlasted the trainer's wait
    if version not in ref["tables"] or version != (want_version or version):
        raise AssertionError(f"fresh client restored v{version}")
    _assert_tables_equal(state_tables(torch, latest), ref["tables"][version],
                         f"v{version} restored by a fresh client")
    readback = {}
    fresh = trainer.VelocClient(
        trainer.make_pipeline(trainer.parse_args(a["args"])),
        trainer.Cluster(trainer.TierTopology(scratch=str(scratch))))
    try:
        for v in sorted(ref["tables"]):
            if v == version:
                continue
            t0 = time.perf_counter()
            regs = rst.load_rank_regions(fresh.cluster, fresh.name, v, 0)
            _assert_tables_equal(state_tables(torch, regs), ref["tables"][v],
                                 f"v{v} read back by a fresh client")
            readback[v] = time.perf_counter() - t0
            del regs
    finally:
        fresh.shutdown()
    marks.append(("read back", time.perf_counter()))

    def rate(xs):
        return len(xs) / sum(xs)

    out = {
        "largest_region_rows": -(-max(sizes) // 8192),
        "state_bytes": sum(sizes), "leaves": len(sizes),
        "step_ms_ckpt": {k: v * 1e3 for k, v in
                         _stats(run.step_s[1:]).items()},
        "step_ms_no_ckpt": {k: v * 1e3 for k, v in
                            _stats(ref["step_s"][1:]).items()},
        "ckpt_overhead": 1 - rate(run.step_s[1:]) / rate(ref["step_s"][1:]),
        "app_blocking_s": run.app_blocking_s,
        "failure_wait_s": run.failure_wait_s,
        "drain_s": run.drain_s,
        "restart_s": {"at_failure": run.restart_s[0], "fresh": restart_s},
        "recovered": r, "fresh_restored": version,
        "readback_s": readback,
        "versions": {str(i): {k: v for k, v in res.items()
                              if k.endswith(".status") or k in
                              ("shard_bytes", "app_blocking_s", "errors")}
                     for i, res in zip(range(path["every"], steps + 1,
                                             path["every"]),
                                       run.ckpt_results)},
        "peak_device_gb": a["peak_bytes"] / 1e9,
        "host": a["host"],
        "loss": {"first": run.losses[0], "last": run.losses[-1],
                 "max_gap_to_reference": gap},
        "profile_step": ref["profile"],
        "idle_share_no_ckpt": 1 - ref["profile"]["device_busy_ms"] / (
            statistics.median(ref["step_s"][1:]) * 1e3),
        "warnings": sorted({f"{w.category.__name__}: {str(w.message)[:200]}"
                            for w in caught}),
        "launches": {k: launches_run[k] + launches_restart[k]
                     for k in launches_run},
        "phase_s": {mark: t - prev for (_, prev), (mark, t) in
                    zip(marks, marks[1:])}}
    return out, run, latest, a["samples"]


def xlstm_train_path(torch, scratch: Path, seed: int, run_path) -> tuple:
    """The xlstm-1.3b train path (``checked_train_path``): the trainer at
    full width cut to ``XLSTM_LAYERS`` layers (24 of 48: 1,026,893,992
    parameters; f32 with AdamW moments, 12.32 GB), batch 8 x 256, bf16
    compute, a checkpoint every ``XLSTM_EVERY`` steps, the failure after
    ``XLSTM_FAIL``.  ``--capture standalone``: the fused capture clones the
    whole state in every step and keeps the previous step's clone alive
    through the next, so with a version still in its device-to-host copy
    the whole model (48 layers) would hold 4 x 22.17 GB + 7.39 GB of
    gradients, more than the card's 80 GB; the standalone capture clones
    only at a checkpoint, and the cut path keeps it.  The backend must drop
    that clone when its copy to the host ends (``snapshot_release``).  Then
    ``decode_check`` from the restored parameters.  Returns the ``xlstm
    train path`` and ``xlstm decode`` lines."""
    import gc

    scratch.mkdir(parents=True, exist_ok=True)
    disk = subprocess.run(["df", "-h", str(scratch)], capture_output=True,
                          text=True, timeout=60).stdout
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout
    print(f"xlstm path scratch:\n{disk}{free}", end="")
    out, run, latest, samples = checked_train_path(
        torch, XLSTM_PATH, scratch, seed, run_path, "xlstm")
    release = snapshot_release(samples, run.ckpt_results[0],
                               out["state_bytes"])
    params = latest["params"]
    del latest, run
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = path_config(XLSTM_PATH)
    decode = decode_check(torch, cfg, on_card(cfg, params), seed + 5)
    del params
    out["phase_s"]["decode"] = time.perf_counter() - t0
    out = {"config": {"arch": "xlstm-1.3b", "layers": XLSTM_LAYERS,
                      "batch": [8, 256],
                      "state_bytes": out.pop("state_bytes"),
                      "leaves": out.pop("leaves"), "steps": XLSTM_STEPS,
                      "ckpt_every": XLSTM_EVERY, "fail_at": XLSTM_FAIL},
           "capture": "standalone (fused, at the whole model's 48 layers: "
                      "4 x 22.17 GB of state and snapshots + 7.39 GB of "
                      "gradients exceed the card's 80 GB)",
           "snapshot_release": release, **out}
    return out, decode


def recurrentgemma_step(torch, seed: int) -> dict:
    """recurrentgemma-2b cut to ``RG_LAYERS`` layers, one period of its
    pattern (rglru, rglru, local_attn), at full width and with its
    256,000-token vocabulary (``RG_PARAMS`` parameters, 18.8 GB of train
    state): ``RG_STEPS`` train steps without checkpoints through the port's
    own parts (batch 8 x 256, bf16 compute; losses finite), then
    ``decode_check``."""
    import gc
    import math

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.capture import leaves_with_paths
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = get_config("recurrentgemma-2b").replace(num_layers=RG_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    n = sum(t.numel() for _, t in leaves_with_paths(state["params"]))
    if n != RG_PARAMS:
        raise AssertionError(f"recurrentgemma cut: {n} parameters")
    stream = SyntheticStream(cfg, ShapeCfg("cli", 256, 8, "train"),
                             seed=1234, device="cuda")
    step = make_train_step(cfg)
    losses, step_s = [], []
    for i in range(RG_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, stream.batch(i))
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"recurrentgemma losses {losses}")
    out = {"layers": RG_LAYERS, "params": n,
           "state_bytes": sum(t.numel() * t.element_size()
                              for _, t in leaves_with_paths(state)),
           "losses": losses,
           "step_ms": {k: v * 1e3 for k, v in _stats(step_s[1:]).items()},
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    params = state["params"]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["decode"] = decode_check(torch, cfg, on_card(cfg, params), seed + 6)
    return out


#: the whisper train path: whisper-medium whole, batch 8 x 1500 frames
#: (448 decoder tokens), a checkpoint every 2 steps, the failure after step
#: 3 (recovery from v2), the default fused capture, every version kept
WHISPER_FRAMES = 1500
WHISPER_PATH = {"arch": "whisper-medium", "seq_len": WHISPER_FRAMES,
                "batch": 8, "steps": 4, "every": 2, "fail": 3,
                "flags": ["--capture", "fused"]}
WHISPER_PARAMS = 811_657_216
#: serving: rows, prompt tokens and greedy decode steps; the decode checks'
#: prompts (whisper: 400 + 16 tokens within its 448; vision: 240 text
#: tokens after the 576 patches) and their float64 depth
SERVE_ROWS, SERVE_PROMPT, SERVE_STEPS = 2, 4, 16
WHISPER_DECODE_PROMPT, VISION_DECODE_PROMPT = 400, 240
F64_LAYERS = 4
#: f32 decode rows against the f32 forward at full width: float32
#: roundings (about 6e-8 of logits up to ~6) summed in other orders by the
#: one-token and the whole-sequence matrix products, through 48 or 32
#: layers of sums of up to 4096 terms
STUB_F32_TOL = 1e-3
VISION_ROWS = 4
VISION_PARAMS = 3_822_259_200


def whisper_train_path(torch, scratch: Path, seed: int, run_path) -> tuple:
    """The whisper-medium train path (``checked_train_path``), nothing cut
    (24 + 24 layers, d_model 1024, vocab 51,865; 811,657,216 parameters,
    with AdamW 9.74 GB): the trainer at batch 8, frames (8, 1500, 1024) and
    tokens (8, 448), bf16 compute, ``--capture fused`` (4 x 9.74 GB of state
    and snapshots + 3.25 GB of gradients fit), v2 and v4, a failure after
    step 3 and recovery from v2; the fresh client must restore v4.
    Returns the ``whisper train path`` line, and the parameters of v4 as
    the fresh client restored it and as the live trainer left them."""
    from repro_torch.core.capture import leaves_with_paths

    path = WHISPER_PATH
    out, run, latest, _ = checked_train_path(
        torch, path, scratch, seed, run_path, "whisper",
        want_version=path["steps"], keep_live=True)
    n_params = sum(t.numel() for _, t in leaves_with_paths(
        run.state["params"]))
    if n_params != WHISPER_PARAMS:
        raise AssertionError(f"whisper-medium: {n_params} parameters")
    out = {"config": {"arch": path["arch"], "layers": [24, 24],
                      "params": n_params,
                      "frames": [path["batch"], WHISPER_FRAMES, 1024],
                      "tokens": [path["batch"], 448],
                      "state_bytes": out.pop("state_bytes"),
                      "leaves": out.pop("leaves"), "steps": path["steps"],
                      "ckpt_every": path["every"], "fail_at": path["fail"],
                      "capture": "fused"}, **out}
    return out, latest["params"], run.state["params"]


def greedy_serve(torch, cfg, params, batch: dict, steps: int) -> dict:
    """Prefill of ``batch`` into self-attention caches sized for the
    context (the encoder-decoder's ``dec_max_len``; the vision stub's
    patches, prompt and ``steps``), then ``steps`` greedy decode steps
    from its last logits.  Returns every row of logits (B, 1 + steps, V),
    the tokens chosen and the host ms of the prefill and of each step."""
    from repro_torch.models.model import make_decode_fn, make_prefill_fn

    T = batch["tokens"].shape[1]
    P = batch["patches"].shape[1] if "patches" in batch else 0
    cache_len = cfg.dec_max_len if cfg.is_encoder_decoder else P + T + steps
    decode = make_decode_fn(cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = make_prefill_fn(cfg, cache_len=cache_len)(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        rows, toks, step_ms = [lg], [lg.argmax(-1)], []
        for i in range(steps):
            t0 = time.perf_counter()
            lg, cache = decode(params, cache,
                               toks[-1][:, None].to(torch.int32), P + T + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(lg)
            toks.append(lg.argmax(-1))
    return {"logits": torch.stack(rows, dim=1),
            "tokens": torch.stack(toks, dim=1), "prefill_ms": prefill_ms,
            "step_ms": step_ms}


def whisper_serve(torch, restored, live, seed: int) -> dict:
    """The fresh client's restored v4 serves: prefill of frames
    (``SERVE_ROWS``, 1500, 1024) and a prompt of ``SERVE_PROMPT`` tokens
    in bf16 (the trained compute dtype), the self caches sized for
    ``dec_max_len``, then ``SERVE_STEPS`` greedy decode steps; the same
    from the live trainer's v4.  Every logit and every token must be equal
    bit for bit (deterministic algorithms on): after a failure the
    restored weights answer as the live ones would."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-medium")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"frames": (torch.randn((SERVE_ROWS, WHISPER_FRAMES,
                                     cfg.d_model), generator=gen,
                                    device="cuda") * 0.02).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab_size,
                                     (SERVE_ROWS, SERVE_PROMPT),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = greedy_serve(torch, cfg, restored, batch, SERVE_STEPS)
        want = greedy_serve(torch, cfg, live, batch, SERVE_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    equal = torch.equal(got["logits"], want["logits"])
    same_tokens = torch.equal(got["tokens"], want["tokens"])
    out = {"rows": SERVE_ROWS, "frames": WHISPER_FRAMES,
           "prompt": SERVE_PROMPT, "steps": SERVE_STEPS,
           "cache_len": cfg.dec_max_len, "compute": cfg.compute_dtype,
           "logits_equal": equal, "tokens_equal": same_tokens,
           "max_abs_diff": float((got["logits"] - want["logits"]).abs()
                                 .max()),
           "tokens": got["tokens"].tolist(),
           "finite": bool(torch.isfinite(got["logits"]).all()),
           "prefill_ms": {"restored": got["prefill_ms"],
                          "live": want["prefill_ms"]},
           "decode_ms_per_step": {"restored": _stats(got["step_ms"]),
                                  "live": _stats(want["step_ms"])}}
    if not (equal and same_tokens and out["finite"]):
        raise AssertionError(f"the restored v4 serves other logits than the "
                             f"live v4: {out}")
    return out


def vision_serve(torch, seed: int) -> dict:
    """phi-3-vision-4.2b at full width and depth (32 layers, d_model 3072,
    576 patches; 3,822,259,200 parameters, 15.3 GB in f32) from a seeded
    initialisation on the card: rows of 576 patches and a text prompt
    served in bf16 (prefill, then ``SERVE_STEPS`` greedy decode steps),
    then ``decode_check`` (f32 at full depth within ``STUB_F32_TOL``,
    float64 cut to ``F64_LAYERS`` layers within ``F64_TOL``)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.capture import leaves_with_paths
    from repro_torch.models.model import init_model

    cfg = get_config("phi-3-vision-4.2b")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(cfg, generator=gen, device="cuda")
    n = sum(t.numel() for _, t in leaves_with_paths(params))
    if n != VISION_PARAMS:
        raise AssertionError(f"phi-3-vision-4.2b: {n} parameters")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (VISION_ROWS, VISION_DECODE_PROMPT),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "patches": (torch.randn((VISION_ROWS, cfg.num_patches,
                                      cfg.d_model), generator=gen,
                                     device="cuda") * 0.02
                         ).to(torch.bfloat16)}
    served = greedy_serve(torch, cfg, params, batch, SERVE_STEPS)
    if not torch.isfinite(served["logits"]).all() or \
            int(served["tokens"].max()) >= cfg.vocab_size:
        raise AssertionError("vision serve: non-finite logits or a padded "
                             "token")
    out = {"config": {"arch": cfg.name, "layers": cfg.num_layers,
                      "params": n, "rows": VISION_ROWS,
                      "patches": cfg.num_patches,
                      "text": VISION_DECODE_PROMPT, "steps": SERVE_STEPS,
                      "compute": cfg.compute_dtype},
           "prefill_ms": served["prefill_ms"],
           "decode_ms_per_step": _stats(served["step_ms"]),
           "peak_device_gb_serve": torch.cuda.max_memory_allocated() / 1e9}
    del served
    gc.collect()
    torch.cuda.empty_cache()
    out["decode"] = decode_check(torch, cfg,
                                 on_card(cfg, params, F64_LAYERS), seed + 1,
                                 prompt=VISION_DECODE_PROMPT,
                                 f32_tol=STUB_F32_TOL)
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def sinusoidal_gap(torch) -> dict:
    """whisper-medium's encoder position table (T = 1500, d = 1024,
    ``layers.sinusoidal_pos``) computed on the card beside the CPU's and a
    float64 table rounded once to f32: the largest gaps and the entries
    that differ.  Torch's CUDA ``sin``/``cos`` may round otherwise than
    its CPU ones."""
    from repro_torch.models.layers import sinusoidal_pos

    T, d = WHISPER_FRAMES, 1024
    card = sinusoidal_pos(T, d, torch.float32, device="cuda").cpu()
    cpu = sinusoidal_pos(T, d, torch.float32, device="cpu")
    f64 = sinusoidal_pos(T, d, torch.float64, device="cpu").float()
    out = {"T": T, "d": d,
           "cuda_vs_cpu": float((card - cpu).abs().max()),
           "cuda_vs_cpu_unequal": int((card != cpu).sum()),
           "cuda_vs_float64": float((card - f64).abs().max()),
           "cpu_vs_float64": float((cpu - f64).abs().max())}
    print(f"sinusoidal_pos (T={T}, d={d}): card vs CPU largest gap "
          f"{out['cuda_vs_cpu']:.3e} ({out['cuda_vs_cpu_unequal']} entries "
          f"differ); card vs float64 {out['cuda_vs_float64']:.3e}, CPU vs "
          f"float64 {out['cpu_vs_float64']:.3e}")
    return out


EXAMPLES = ("quickstart", "incremental", "serve", "branch_explore",
            "train_resilient")


def examples_path(torch, scratch: Path, counters: dict) -> dict:
    """The port's five examples (``repro_torch.examples``) on the card at
    their own sizes, each through its ``main`` to its "OK" with
    ``--scratch`` under ``scratch``: per example the seconds it took, its
    checksum and block-hash launches, and what it returned (the
    incremental per-version table; serve's replica held to the primary's
    logits and tokens bit for bit, under deterministic algorithms)."""
    import importlib

    import numpy as np

    out = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        before = {k: c.value for k, c in counters.items()}
        deterministic = name == "serve"
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        t0 = time.perf_counter()
        try:
            res = mod.main(["--scratch", str(scratch / name)])
        finally:
            torch.use_deterministic_algorithms(False)
        entry = {"s": time.perf_counter() - t0,
                 "launches": {k: counters[k].value - before[k]
                              for k in ("checksum", "blockhash")}}
        if name == "quickstart":
            entry.update(blocking_ms=res["blocking_ms"],
                         levels=res["levels"], restored=res["version"])
        elif name == "incremental":
            entry.update(table=[list(r) for r in res["table"]],
                         chain=res["chain"], compacted=res["compacted"])
        elif name == "serve":
            equal = np.array_equal(res["replica_logits"],
                                   res["logits"][:, 12:])
            same = np.array_equal(res["replica"], res["primary"][:, 12:])
            entry.update(blocked_ms=res["blocked_ms"], logits_equal=equal,
                         tokens_equal=same,
                         tokens=res["primary"].tolist())
            if not (equal and same):
                raise AssertionError(f"serve example: the replica differs "
                                     f"from the primary: {entry}")
        elif name == "branch_explore":
            entry.update(trunk_loss=res["trunk_loss"],
                         branches=res["results"], best=res["best"])
        else:
            entry.update(loss_first=res.losses[0], loss_last=res.losses[-1],
                         steps=len(res.losses),
                         recovered=res.recovered_version,
                         app_blocking_ms=[b * 1e3 for b in
                                          res.app_blocking_s],
                         drain_s=res.drain_s)
        if entry["launches"]["checksum"] <= 0:
            raise AssertionError(f"example {name}: no checksum launch")
        out[name] = entry
        print(f"example {name}: OK in {entry['s']:.1f} s, launches "
              f"{entry['launches']}")
        shutil.rmtree(scratch / name, ignore_errors=True)
    if out["incremental"]["launches"]["blockhash"] <= 0:
        raise AssertionError("example incremental: no block-hash launch")
    return out


#: the live clones at full width: rows, prompt, context, greedy steps
#: compared, the step after which the clone is taken, steps timed after
#: the drain.  phi3-mini-3.8b (per-head K/V caches) and minicpm3-4b's MLA
#: form (a latent cache) with their parameter counts
CLONE_ARCH = "phi3-mini-3.8b"
CLONE_PARAMS = 3_822_259_200
MLA_ARCH, MLA_FORM = "minicpm3-4b", {"block_pattern": ("mla",)}
MLA_PARAMS = 4_262_025_728
#: 62 layers x 4 rows x 512 slots x (latent 256 + rope 32) x 2 bytes
MLA_CACHE_BYTES = 73_138_176
#: the minicpm3 decode line: both forms at full width cut to 4 layers
MINICPM3_DECODE_LAYERS = 4
CLONE_ROWS, CLONE_PROMPT, CLONE_CONTEXT = 4, 256, 512
CLONE_STEPS, CLONE_AT, CLONE_AFTER = 32, 12, 8
#: the MoE archs at full width cut to one layer (one grok layer's 8
#: experts are 9.66 GB in bf16; kimi's one layer, 38.76 GB, is served but
#: not cloned: a clone of it would pass through the host's memory), with
#: their parameter counts; grok's K/V caches (1 layer x k, v x 4 rows x
#: 512 slots x 8 heads x 128 x 2 bytes); kimi's greedy steps
GROK_ARCH, KIMI_ARCH, MOE_LAYERS = "grok-1-314b", "kimi-k2-1t-a32b", 1
GROK_PARAMS, KIMI_PARAMS = 6_530_598_912, 19_378_623_488
GROK_CACHE_BYTES = 8_388_608
KIMI_STEPS = 16


def kv_cache_bytes(cfg, rows: int, context: int) -> int:
    """The bytes of the per-head K/V caches of ``cfg``'s plain-attention
    form for ``rows`` and ``context`` in the compute dtype, computed (the
    MLA form's latent cache is measured beside it)."""
    from repro_torch.models.layers import cdt

    return cfg.num_layers * 2 * rows * context * cfg.num_kv_heads * \
        cfg.head_dim * cdt(cfg).itemsize


@contextlib.contextmanager
def moe_routing():
    """Inside, each call of the port's ``moe._moe_block`` also appends its
    config, input and router to the list yielded (its work is unchanged);
    ``routing_stats`` reads them afterwards."""
    from repro_torch.models import moe

    block, calls = moe._moe_block, []

    def recorded(cfg, x, router_w, *experts):
        calls.append((cfg, x, router_w))
        return block(cfg, x, router_w, *experts)

    moe._moe_block = recorded
    try:
        yield calls
    finally:
        moe._moe_block = block


def routing_stats(torch, calls) -> list:
    """Per recorded MoE call: its tokens, slots (tokens x k), capacity C
    per expert, dropped slots, and the fewest and most slots one expert was
    routed and kept, from the port's own ``_route`` and ``_dispatch`` on
    the call's inputs."""
    from repro_torch.models import moe

    out = []
    for cfg, x, router_w in calls:
        E = cfg.moe.num_experts
        C = moe._capacity(x.shape[0], cfg)
        ids, _ = moe._route(router_w, cfg, x)
        flat = ids.reshape(-1)
        _, keep = moe._dispatch(flat, E, C)
        routed = torch.bincount(flat, minlength=E)
        kept = torch.bincount(flat[keep], minlength=E)
        out.append({"tokens": x.shape[0], "slots": flat.numel(),
                    "capacity": C, "dropped": int((~keep).sum()),
                    "routed_load": [int(routed.min()), int(routed.max())],
                    "kept_load": [int(kept.min()), int(kept.max())]})
    return out


def serve_clone(torch, scratch: Path, seed: int, cfg, want_params: int
                ) -> dict:
    """DeepClone at full width: ``cfg`` whole (phi3-mini-3.8b: 32 layers,
    d_model 3072, 32 heads, d_ff 8192, vocab 32,064, 3,822,259,200
    parameters, 15.3 GB in f32; minicpm3-4b's MLA form: 62 layers, d_model
    2560, 40 heads, d_ff 6400, vocab 73,448, 4,262,025,728 parameters, 17.05
    GB) or cut in depth (grok-1-314b: 1 layer, d_model 6144, 48 heads, 8
    experts of d_ff 32,768, top-2, vocab 131,072, 6,530,598,912 parameters,
    13.06 GB in bf16) from a seeded initialisation on the card serves
    ``CLONE_ROWS`` rows: a prefill of ``CLONE_PROMPT`` tokens into caches of
    ``CLONE_CONTEXT``, then ``CLONE_STEPS`` greedy decode steps in bf16.
    After step ``CLONE_AT`` an async serialize/local/flush checkpoint takes
    the serving state (params, caches, token, position) while decoding
    goes on, and goes on past the compared steps until the clone has
    drained (then ``CLONE_AFTER`` more).  A fresh client on the same
    scratch restores the clone from a ``meta`` template (no memory) and
    continues to step ``CLONE_STEPS``: its logits and tokens must equal
    the primary's bit for bit (deterministic algorithms), and its params'
    and caches' per-leaf Fletcher tables the live ones'.  A MoE config
    also reports its prefill's routing (``routing_stats``).  The line's
    ``largest_leaf_rows`` is the checksum rows of the largest table the
    state checks launch, at which phase 8 holds the kernel."""
    import gc

    from repro_torch.core import ModuleSpec, PipelineSpec, VelocClient
    from repro_torch.core.capture import leaves_with_paths
    from repro_torch.models.model import (cache_init, count_params,
                                          init_model, make_decode_fn,
                                          make_prefill_fn)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(cfg, generator=gen, device="cuda")
    n = sum(t.numel() for _, t in leaves_with_paths(params))
    if not n == count_params(cfg)["total"] == want_params:
        raise AssertionError(f"{cfg.name} {cfg.block_pattern}: {n} "
                             f"parameters")
    prompt = torch.randint(0, cfg.vocab_size, (CLONE_ROWS, CLONE_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    spec = PipelineSpec(name="serve-clone", mode="async", modules=[
        ModuleSpec("serialize"), ModuleSpec("local"), ModuleSpec("flush")])
    client = VelocClient(spec, scratch=str(scratch))
    decode = make_decode_fn(cfg)
    step_ms = {"before": [], "drain": [], "after": []}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad(), MemorySampler(torch) as mem:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with moe_routing() as routed:
                lg, cache = make_prefill_fn(cfg, cache_len=CLONE_CONTEXT)(
                    params, {"tokens": prompt})
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            tok = lg.argmax(-1)[:, None].to(torch.int32)
            rows, toks, fut = [], [tok], None
            pos, context_wait_s = CLONE_PROMPT, 0.0
            while fut is None or pos < CLONE_PROMPT + CLONE_STEPS or \
                    len(step_ms["after"]) < CLONE_AFTER:
                phase = "before" if fut is None else (
                    "after" if fut.done() else "drain")
                if phase == "drain" and pos + CLONE_AFTER >= CLONE_CONTEXT:
                    t0 = time.perf_counter()  # no room left: wait
                    fut.result(timeout=600)
                    context_wait_s = time.perf_counter() - t0
                    continue
                t0 = time.perf_counter()
                lg, cache = decode(params, cache, tok, pos)
                tok = lg.argmax(-1)[:, None].to(torch.int32)
                torch.cuda.synchronize()
                step_ms[phase].append((time.perf_counter() - t0) * 1e3)
                pos += 1
                if pos <= CLONE_PROMPT + CLONE_STEPS:
                    rows.append(lg)
                    toks.append(tok)
                if pos == CLONE_PROMPT + CLONE_AT:
                    clone = {"params": params, "cache": cache, "tok": tok,
                             "pos": torch.tensor(pos - 1, dtype=torch.int32,
                                                 device="cuda")}
                    t_clone = time.monotonic()
                    fut = client.checkpoint(clone, version=1,
                                            meta={"pos": pos - 1})
                    call_s = time.monotonic() - t_clone
                    blocking_s = fut.results["app_blocking_s"]
            fut.result(timeout=600)
            drain_s = max(v for k, v in fut.results.items()
                          if k.endswith(".done_at")) - t_clone
        leaf_bytes = [t.numel() * t.element_size()
                      for _, t in leaves_with_paths(clone)]
        clone_bytes = sum(leaf_bytes)
        release = snapshot_release(mem.samples, fut.results, clone_bytes,
                                   t_call=t_clone)
        served = pos - CLONE_PROMPT
        client.shutdown()
        del cache, lg
        gc.collect()

        # --- the replica: a fresh client, a template of no memory ---------
        template = {"params": init_model(cfg, generator=torch.Generator(),
                                         device="meta"),
                    "cache": cache_init(cfg, CLONE_ROWS, CLONE_CONTEXT,
                                        device="meta"),
                    "tok": torch.empty((CLONE_ROWS, 1), dtype=torch.int32,
                                       device="meta"),
                    "pos": torch.empty((), dtype=torch.int32, device="meta")}
        fresh = VelocClient(spec, scratch=str(scratch))
        t0 = time.perf_counter()
        v, snap = fresh.restart_latest(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        fresh.shutdown()
        if v != 1:
            raise AssertionError(f"{cfg.name} serve clone: the fresh client "
                                 f"restored v{v}: "
                                 f"{fresh.restart_diagnostics}")
        if any(t.device.type != "cuda" for _, t in leaves_with_paths(snap)):
            raise AssertionError(f"{cfg.name} serve clone: a restored leaf "
                                 f"is not on the card")
        _assert_tables_equal(state_tables(torch, snap["params"]),
                             state_tables(torch, clone["params"]),
                             f"{cfg.name} serve clone params")
        _assert_tables_equal(state_tables(torch, snap["cache"]),
                             state_tables(torch, clone["cache"]),
                             f"{cfg.name} serve clone caches")
        if not (torch.equal(snap["tok"], clone["tok"])
                and int(snap["pos"]) == int(clone["pos"])):
            raise AssertionError(f"{cfg.name} serve clone: token or "
                                 f"position differs")
        with torch.no_grad():
            r_cache, r_tok, r_rows, r_toks = snap["cache"], snap["tok"], \
                [], []
            for p in range(int(snap["pos"]) + 1,
                           CLONE_PROMPT + CLONE_STEPS):
                lg, r_cache = decode(snap["params"], r_cache, r_tok, p)
                r_tok = lg.argmax(-1)[:, None].to(torch.int32)
                r_rows.append(lg)
                r_toks.append(r_tok)
    finally:
        torch.use_deterministic_algorithms(False)
    live_rows = torch.stack(rows[CLONE_AT:], 1)
    live_toks = torch.cat(toks[CLONE_AT + 1:], 1)
    got_rows, got_toks = torch.stack(r_rows, 1), torch.cat(r_toks, 1)
    out = {"config": {"arch": cfg.name, "blocks": cfg.block_pattern,
                      "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "params": n,
                      "rows": CLONE_ROWS, "prompt": CLONE_PROMPT,
                      "context": CLONE_CONTEXT, "steps": CLONE_STEPS,
                      "clone_after_step": CLONE_AT,
                      "compute": cfg.compute_dtype,
                      "clone_bytes": clone_bytes,
                      "cache_bytes": sum(
                          t.numel() * t.element_size()
                          for _, t in leaves_with_paths(clone["cache"]))},
           "logits_equal": torch.equal(got_rows, live_rows),
           "tokens_equal": torch.equal(got_toks, live_toks),
           "replica_steps": got_rows.shape[1],
           "finite": bool(torch.isfinite(live_rows).all()),
           "tables_equal": True,
           "largest_leaf_rows": -(-max(leaf_bytes) // 8192),
           "app_blocking_ms": blocking_s * 1e3, "call_ms": call_s * 1e3,
           "prefill_ms": prefill_ms,
           "decode_ms_per_step": {k: _stats(v) if v else None
                                  for k, v in step_ms.items()},
           "steps_served": served,
           "steps_during_drain": len(step_ms["drain"]),
           "context_full_wait_s": context_wait_s,
           "drain_s": drain_s, "snapshot": release,
           "fresh_restore_s": restore_s,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "host": _host_memory()}
    if cfg.moe is not None:
        out["prefill_routing"] = routing_stats(torch, routed)
    if not (out["logits_equal"] and out["tokens_equal"] and out["finite"]):
        raise AssertionError(f"{cfg.name} serve clone: the replica differs "
                             f"from the primary: {out}")
    return out


def minicpm3_decode(torch, seed: int) -> dict:
    """``decode_check`` of minicpm3-4b at full width (d_model 2560, 40
    heads, vocab 73,448) cut to ``MINICPM3_DECODE_LAYERS`` layers, in the
    registered plain-attention form and the MLA form, each from a seeded
    initialisation on the card: f32 within ``STUB_F32_TOL`` and float64
    within ``F64_TOL`` of the forward pass."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model

    out = {}
    for form, over in (("attn", {}), ("mla", MLA_FORM)):
        cfg = get_config(MLA_ARCH).replace(
            num_layers=MINICPM3_DECODE_LAYERS, **over)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_model(cfg, generator=gen, device="cuda")
        out[form] = decode_check(torch, cfg, on_card(cfg, params),
                                 seed + 1, f32_tol=STUB_F32_TOL)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_config(arch: str, **moe):
    """``arch`` at full width cut to ``MOE_LAYERS``, its ``MoECfg`` fields
    overridden by ``moe``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.replace(num_layers=MOE_LAYERS,
                       moe=dataclasses.replace(cfg.moe, **moe))


def grok_decode(torch, seed: int) -> dict:
    """``decode_check`` of grok-1-314b at full width cut to ``MOE_LAYERS``
    at ``capacity_factor = E / k``: C >= N, so no slot drops in the
    forward pass either, and decode can equal it.  The parameters are
    drawn anew in each run's dtype from one seed (26.1 GB in f32, 52.2 GB
    in float64), one copy at a time: f32 within ``STUB_F32_TOL``, float64
    within ``F64_TOL``."""
    import gc

    from repro_torch.models.model import init_model

    m = moe_config(GROK_ARCH).moe
    cfg = moe_config(GROK_ARCH,
                     capacity_factor=m.num_experts / m.experts_per_token)

    def build(dtype):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return cfg, init_model(cfg.replace(param_dtype=dtype),
                               generator=gen, device="cuda")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = decode_check(torch, cfg, build, seed + 1, f32_tol=STUB_F32_TOL)
    out["capacity_factor"] = cfg.moe.capacity_factor
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def kimi_serve(torch, seed: int) -> dict:
    """kimi-k2-1t-a32b at full width (d_model 7168, 64 heads, 8 KV heads,
    384 experts of d_ff 2048, top-8, vocab 163,840) cut to ``MOE_LAYERS``
    (19,378,623,488 parameters, 38.76 GB in bf16) from a seeded
    initialisation on the card: a prompt of ``CLONE_PROMPT`` tokens in
    ``CLONE_ROWS`` rows, then ``KIMI_STEPS`` greedy decode steps in bf16.
    Tokens must lie in the vocabulary and logits be finite; the prefill's
    routing (``routing_stats``) and the decode steps' dropped slots are
    reported."""
    import gc

    from repro_torch.core.capture import leaves_with_paths
    from repro_torch.models.model import count_params, init_model

    cfg = moe_config(KIMI_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for _, t in leaves_with_paths(params))
    if not n == count_params(cfg)["total"] == KIMI_PARAMS:
        raise AssertionError(f"{cfg.name}: {n} parameters")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (CLONE_ROWS, CLONE_PROMPT),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    with moe_routing() as routed:
        served = greedy_serve(torch, cfg, params, batch, KIMI_STEPS)
    stats = routing_stats(torch, routed)
    out = {"config": {"arch": cfg.name, "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
                      "top_k": cfg.moe.experts_per_token, "params": n,
                      "rows": CLONE_ROWS, "prompt": CLONE_PROMPT,
                      "steps": KIMI_STEPS, "compute": cfg.compute_dtype,
                      "param_dtype": cfg.param_dtype},
           "init_s": init_s,
           "prefill_ms": served["prefill_ms"],
           "decode_ms_per_step": _stats(served["step_ms"]),
           "prefill_routing": stats[:cfg.num_layers],
           "decode_dropped": sum(s["dropped"]
                                 for s in stats[cfg.num_layers:]),
           "finite": bool(torch.isfinite(served["logits"]).all()),
           "tokens_in_vocab": int(served["tokens"].max()) < cfg.vocab_size,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, served
    gc.collect()
    torch.cuda.empty_cache()
    if not (out["finite"] and out["tokens_in_vocab"]):
        raise AssertionError(f"kimi serve: non-finite logits or a token out "
                             f"of the vocabulary: {out}")
    return out


def _assert_tree_equal(torch, got, want, what: str):
    from repro_torch.core.capture import leaves_with_paths

    g, w = leaves_with_paths(got), leaves_with_paths(want)
    _assert_equal(torch, dict(g), dict(w), what)


def check_q8_ring_kernels(torch, gen, big_n: int, stripe_words: int) -> dict:
    """Phase 8 for the q8 and ring kernels: quantize, dequantize and
    xor_pair against their plain versions, bit for bit, at small, ragged
    and misaligned shapes, at NaN, ±inf, all-zero and f16 blocks, and at
    the paths' own: the largest leaf's ``big_n`` values and the ring's
    stripe of ``stripe_words`` words; xor_pair also at a whole number of
    its blocks and at a length that ends in a ragged block and a scalar
    tail."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    from repro_torch.kernels import xor_parity as xp

    stats, errs = {}, {"quantize": [], "dequantize": [], "xor_pair": []}
    special = torch.randn(7 * 256, generator=gen, device="cuda")
    special[256 + 7] = float("nan")
    special[3 * 256:4 * 256] = 0
    special[5 * 256 + 9] = float("inf")
    special[6 * 256 + 1] = float("-inf")
    cases = [("path", torch.randn(big_n, generator=gen, device="cuda") * 3),
             ("1 value", torch.randn(1, generator=gen, device="cuda")),
             ("255 values", torch.randn(255, generator=gen, device="cuda")),
             ("ragged 3*256+77",
              torch.randn(3 * 256 + 77, generator=gen, device="cuda") * 50),
             ("misaligned", torch.randn(1001 + 1, generator=gen,
                                        device="cuda")[1:]),
             ("NaN, zero, +-inf blocks", special),
             ("f16 input", (torch.randn(5000, generator=gen, device="cuda")
                            * 8).half().float())]
    for what, x in cases:
        n = x.numel()
        q, s = qz.quantize(x)
        qr, sr = ref.quantize_flat_ref(x)
        errs["quantize"].append(_check_exact(
            torch, f"quantize {what} ({n})", (q, s), (qr, sr)))
        errs["dequantize"].append(_check_exact(
            torch, f"dequantize {what} ({n})", qz.dequantize(q, s, n),
            ref.dequantize_ref(q, s).reshape(-1)[:n]))
        if what != "path":
            continue
        rows = qz.blocks(n)
        ms = _cuda_ms(torch, lambda: qz.quantize(x), reps=20)
        plain_ms = _cuda_ms(torch, lambda: ref.quantize_flat_ref(x), reps=5)
        bound = _bound_ms(4 * n + n + 4 * rows)
        print(f"quantize ({n} values = {rows} blocks): bit-exact; kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms, plain {plain_ms:.4f} ms")
        stats["quantize"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 library_ms=None, shape=[rows, 256])
        d_ms = _cuda_ms(torch, lambda: qz.dequantize(q, s, n), reps=20)
        d_plain = _cuda_ms(torch, lambda: ref.dequantize_ref(q, s), reps=5)
        d_lib = _cuda_ms(torch, lambda: torch.mul(q, s[:, None]), reps=20)
        d_bound = _bound_ms(n + 4 * rows + 4 * n)
        print(f"dequantize ({rows} blocks): bit-exact; kernel {d_ms:.4f} ms, "
              f"bound {d_bound:.4f} ms, plain {d_plain:.4f} ms, "
              f"torch.mul(q, s[:, None]) {d_lib:.4f} ms")
        stats["dequantize"] = dict(ms=d_ms, plain_ms=d_plain,
                                   bound_ms=d_bound, library_ms=d_lib,
                                   shape=[rows, 256])
    for name in ("quantize", "dequantize"):
        stats[name]["max_abs_err"] = max(errs[name])

    span = xp.PAIR_BLOCK_WORDS  # words one block of the kernel covers
    for n, off in ((1, False), (1001, False), (4099, False),
                   (stripe_words, False), (4099, True), (2 * span, False),
                   (3 * span + 4 * 37 + 3, False)):
        base_a = _random_words(torch, gen, (n + 1,))
        base_b = _random_words(torch, gen, (n + 1,))
        a, b = (base_a[1:], base_b[1:]) if off else (base_a[:n], base_b[:n])
        want = ref.xor_pair_ref(a, b)
        if off:  # refused by the kernel's wrapper; ops copies it aligned
            try:
                xp.xor_pair(a, b)
            except ValueError:
                pass
            else:
                raise AssertionError("xor_pair launched on a misaligned base")
            got = ops.xor_pair(a, b)
        else:
            got = xp.xor_pair(a, b)
        errs["xor_pair"].append(_check_exact(
            torch, f"xor_pair N={n}{' misaligned' if off else ''}", got,
            want))
        if n != stripe_words:
            continue
        ms = _cuda_ms(torch, lambda: xp.xor_pair(a, b), reps=20)
        plain_ms = _cuda_ms(torch, lambda: ref.xor_pair_ref(a, b), reps=5)
        lib_ms = _cuda_ms(torch, lambda: torch.bitwise_xor(a, b), reps=20)
        bound = _bound_ms(12 * n)
        print(f"xor_pair N={n}: bit-exact; kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms, plain {plain_ms:.4f} ms, torch.bitwise_xor "
              f"{lib_ms:.4f} ms")
        stats["xor_pair"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 library_ms=lib_ms, shape=[n])
    stats["xor_pair"]["max_abs_err"] = max(errs["xor_pair"])
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scratch", default=str(ROOT / "build" / "chip_smoke"),
                    help="build and checkpoint directory (emptied first)")
    ap.add_argument("--trace", default=None,
                    help="profile the checkpoint calls and the drain into "
                         "this directory")
    args = ap.parse_args(argv)
    # cuBLAS is deterministic under the train path's deterministic
    # algorithms only with a fixed workspace, read when its handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    scratch = Path(args.scratch)
    shutil.rmtree(scratch, ignore_errors=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(scratch / "kernels")

    from repro_torch.kernels import _build
    from repro_torch.kernels import blockhash as bh
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import gather as ga
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import xor_parity as xp

    counters = {"checksum": ck.LAUNCHES, "xor_reduce": xp.LAUNCHES,
                "blockhash": bh.LAUNCHES, "blockhash_diff": bh.DIFF_LAUNCHES,
                "gather_rows": ga.LAUNCHES, "quantize": qz.LAUNCHES,
                "dequantize": qz.DEQUANT_LAUNCHES,
                "xor_pair": xp.PAIR_LAUNCHES}

    def run_path(name, kernels, fn):
        """Drive one path with every count at 0 just before it; fail if a
        kernel of the path was not launched."""
        for c in counters.values():
            c.reset()
        out = fn()
        launches = {k: c.value for k, c in counters.items()}
        print(f"{name} launches: {launches}")
        for k in kernels:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"{name}")
        return out, launches

    phase_s, last = {}, [time.perf_counter()]

    def line(name, out):
        """Print a phase's JSON line; its seconds are those since the line
        before."""
        now = time.perf_counter()
        phase_s[name], last[0] = now - last[0], now
        print(f"{name} {json.dumps(out)}")

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

    leaves, ranks, load = make_state(torch, args.seed)
    by_path = {}
    path, by_path["main"] = run_path(
        "main path", ("checksum", "xor_reduce"),
        lambda: main_path(torch, leaves, ranks, scratch / "scratch",
                          trace=Path(args.trace) if args.trace else None))
    print(f"v2 shard is {path['shard_rows']} checksum rows, "
          f"{path['xor_words']} XOR words")
    shutil.rmtree(scratch / "scratch", ignore_errors=True)
    delta, by_path["delta"] = run_path(
        "delta path", ("checksum", "xor_reduce", "blockhash",
                       "blockhash_diff", "gather_rows"),
        lambda: delta_path(torch, leaves, ranks, load, scratch / "delta",
                           args.seed + 2))
    shutil.rmtree(scratch / "delta", ignore_errors=True)
    step = ranks_leaf(ranks, "opt/step")
    step_words = -(-step.numel() * step.element_size() // 4)
    _, by_path["host_delta"] = run_path(
        "host-delta path", ("blockhash", "checksum"),
        lambda: host_delta_path(torch, list(ranks[0].items()), ranks[0],
                                scratch / "host_delta", args.seed + 3))
    shutil.rmtree(scratch / "host_delta", ignore_errors=True)
    line("delta path", delta)
    q8, by_path["q8"] = run_path(
        "q8 path", ("quantize", "dequantize", "checksum", "xor_reduce"),
        lambda: q8_path(torch, ranks, load, scratch / "q8"))
    shutil.rmtree(scratch / "q8", ignore_errors=True)
    line("q8 path", q8)
    ring, by_path["ring"] = run_path(
        "ring path", ("xor_pair",), lambda: ring_path(torch, leaves))
    recovery, by_path["recovery"] = run_path(
        "recovery path", ("checksum", "xor_reduce"),
        lambda: recovery_path(torch, leaves, scratch / "recovery",
                              args.seed + 4))
    shutil.rmtree(scratch / "recovery", ignore_errors=True)
    recovery["launches"] = by_path["recovery"]
    line("recovery path", recovery)
    big_n = max(t.numel() for _, t in leaves)
    del leaves, ranks
    train, by_path["train"] = run_path(
        "train path", ("checksum",),
        lambda: train_path(torch, scratch / "train", args.seed))
    shutil.rmtree(scratch / "train", ignore_errors=True)
    train["launches"] = by_path["train"]
    gru = train.pop("gru")
    line("train path", train)
    line("gru gate", gru)
    sharded, by_path["sharded"] = run_path(
        "sharded path", ("checksum",),
        lambda: sharded_path(torch, scratch / "sharded", args.seed + 20))
    shutil.rmtree(scratch / "sharded", ignore_errors=True)
    sharded["launches"] = by_path["sharded"]
    line("sharded path", sharded)
    interval = interval_check(torch, args.seed)
    line("interval optimizer", interval)
    scans = recurrent_scans(torch, args.seed + 7)
    line("recurrent scans", scans)
    xlstm, xdecode = xlstm_train_path(torch, scratch / "xlstm",
                                      args.seed + 8, run_path)
    shutil.rmtree(scratch / "xlstm", ignore_errors=True)
    by_path["xlstm"] = xlstm["launches"]
    line("xlstm train path", xlstm)
    line("xlstm decode", xdecode)
    rgemma = recurrentgemma_step(torch, args.seed + 9)
    line("recurrentgemma step", rgemma)
    whisper, restored, live = whisper_train_path(
        torch, scratch / "whisper", args.seed + 10, run_path)
    shutil.rmtree(scratch / "whisper", ignore_errors=True)
    by_path["whisper"] = whisper["launches"]
    line("whisper train path", whisper)
    serve = whisper_serve(torch, restored, live, args.seed + 11)
    serve["sinusoidal_pos"] = sinusoidal_gap(torch)
    line("whisper serve from restore", serve)
    del live
    from repro_torch.configs import get_config

    wcfg = get_config("whisper-medium")
    wdecode = decode_check(torch, wcfg, on_card(wcfg, restored, F64_LAYERS),
                           args.seed + 12, prompt=WHISPER_DECODE_PROMPT,
                           f32_tol=STUB_F32_TOL)
    line("whisper decode", wdecode)
    del restored
    torch.cuda.empty_cache()
    vision = vision_serve(torch, args.seed + 13)
    line("vision serve", vision)
    for what, d in (("xlstm", xdecode), ("recurrentgemma", rgemma["decode"]),
                    ("whisper", wdecode), ("vision", vision["decode"])):
        if not d["ok"]:
            raise AssertionError(f"{what} decode differs from the forward "
                                 f"pass beyond its tolerance: {d}")
    examples, by_path["examples"] = run_path(
        "examples", ("checksum", "blockhash"),
        lambda: examples_path(torch, scratch / "examples", counters))
    shutil.rmtree(scratch / "examples", ignore_errors=True)
    line("examples", examples)
    clone, by_path["serve_clone"] = run_path(
        "serve clone", ("checksum",),
        lambda: serve_clone(torch, scratch / "serve_clone", args.seed + 14,
                            get_config(CLONE_ARCH), CLONE_PARAMS))
    shutil.rmtree(scratch / "serve_clone", ignore_errors=True)
    clone["launches"] = by_path["serve_clone"]
    line("serve clone", clone)
    mla_cfg = get_config(MLA_ARCH).replace(**MLA_FORM)
    mclone, by_path["minicpm3"] = run_path(
        "minicpm3 mla serve clone", ("checksum",),
        lambda: serve_clone(torch, scratch / "minicpm3", args.seed + 15,
                            mla_cfg, MLA_PARAMS))
    shutil.rmtree(scratch / "minicpm3", ignore_errors=True)
    mclone["launches"] = by_path["minicpm3"]
    if mclone["config"]["cache_bytes"] != MLA_CACHE_BYTES:
        raise AssertionError(f"minicpm3 mla: latent caches of "
                             f"{mclone['config']['cache_bytes']} bytes")
    # the registered plain-attention form's K/V caches, computed, not run
    mclone["attn_form_cache_bytes"] = kv_cache_bytes(
        get_config(MLA_ARCH), CLONE_ROWS, CLONE_CONTEXT)
    line("minicpm3 mla serve clone", mclone)
    mdecode = minicpm3_decode(torch, args.seed + 16)
    line("minicpm3 decode", mdecode)
    for form, d in mdecode.items():
        if not d["ok"]:
            raise AssertionError(f"minicpm3 {form} decode differs from the "
                                 f"forward pass beyond its tolerance: {d}")
    grok_cfg = moe_config(GROK_ARCH)
    gclone, by_path["grok"] = run_path(
        "grok serve clone", ("checksum",),
        lambda: serve_clone(torch, scratch / "grok", args.seed + 17,
                            grok_cfg, GROK_PARAMS))
    shutil.rmtree(scratch / "grok", ignore_errors=True)
    gclone["launches"] = by_path["grok"]
    if gclone["config"]["cache_bytes"] != GROK_CACHE_BYTES or \
            kv_cache_bytes(grok_cfg, CLONE_ROWS, CLONE_CONTEXT) != \
            GROK_CACHE_BYTES:
        raise AssertionError(f"grok: K/V caches of "
                             f"{gclone['config']['cache_bytes']} bytes")
    line("grok serve clone", gclone)
    gdecode = grok_decode(torch, args.seed + 18)
    line("grok decode", gdecode)
    if not gdecode["ok"]:
        raise AssertionError(f"grok decode differs from the forward pass "
                             f"beyond its tolerance: {gdecode}")
    kimi, by_path["kimi"] = run_path(
        "kimi serve", (), lambda: kimi_serve(torch, args.seed + 19))
    line("kimi serve", kimi)

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    regions = {"xlstm": xlstm["largest_region_rows"],
               "whisper": whisper["largest_region_rows"],
               "serve_clone": clone["largest_leaf_rows"],
               "minicpm3": mclone["largest_leaf_rows"],
               "grok": gclone["largest_leaf_rows"]}
    stats = check_kernels(torch, gen, shard_rows=path["shard_rows"],
                          xor_words=path["xor_words"],
                          train_rows=-(-train["shard_bytes"] // 8192),
                          regions=regions)
    stats.update(check_delta_kernels(
        torch, gen, big_words=delta["big_words"], step_words=step_words,
        dirty_rows=delta["dirty_rows"], dirty_rows_10=delta["dirty_rows_10"],
        chunk=delta["chunk_words"]))
    stats.update(check_q8_ring_kernels(
        torch, gen, big_n=big_n, stripe_words=ring["stripe_words"]))

    # kernel -> (source, TPU kernel it replaces, path whose launches count)
    src = {"checksum": ("src/repro_torch/csrc/checksum.cu",
                        "src/repro/kernels/checksum.py:31", "main"),
           "xor_reduce": ("src/repro_torch/csrc/xor_parity.cu",
                          "src/repro/kernels/xor_parity.py:28", "main"),
           "blockhash": ("src/repro_torch/csrc/blockhash.cu",
                         "src/repro/kernels/checksum.py:84", "delta"),
           "blockhash_diff": ("src/repro_torch/csrc/blockhash.cu",
                              "src/repro/kernels/checksum.py:115", "delta"),
           "gather_rows": ("src/repro_torch/csrc/gather_rows.cu",
                           "src/repro/kernels/checksum.py:149", "delta"),
           "quantize": ("src/repro_torch/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:27", "q8"),
           "dequantize": ("src/repro_torch/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:50", "q8"),
           "xor_pair": ("src/repro_torch/csrc/xor_parity.cu",
                        "src/repro/kernels/xor_parity.py:51", "ring")}
    kernels = []
    for name, (source, replaces, home) in src.items():
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[home][name],
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s.get("library_ms"),
            "call_ms": s.get("call_ms"),
            "library_with_index_copy_ms": s.get("library_with_index_copy_ms"),
            "at_10_percent": s.get("at_10_percent"), "shape": s["shape"],
            **{p: s.get(p) for p in regions}})
    line("phase seconds", dict(phase_s, kernel_checks=time.perf_counter()
                               - last[0]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def ranks_leaf(ranks, name):
    for r in ranks:
        if name in r:
            return r[name]
    raise KeyError(name)


if __name__ == "__main__":
    sys.exit(main())
