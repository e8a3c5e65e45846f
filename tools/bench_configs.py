#!/usr/bin/env python3
"""BASELINE.json config-coverage benchmarks (VERDICT round-1 item 6).

Measures, on the card, with bench.py's rules (content-varied reps, forced
completion by scalar readback, frames staged in device memory):

* config 2: 352x288 CIF IPPP throughput;
* config 3: 720x576 SD IPPP throughput;
* config 4: 1920x1152 with pframes_count=255 (single I then 255 P) - the
  peak-throughput GOP shape named by BASELINE.json;
* config 5: batched 8-stream 1920x1152 aggregate throughput on ONE card via
  BatchEncoder's device-resident scan (on several cards the batch shards
  over the `stream` mesh axis with per-stream bit-exactness).

Methodology: steady-state pipelined, like bench.py - each timed batch queues
`reps` full encodes back-to-back with distinct content and one combined
scalar readback forces completion (charged against the batch); the FPGA
baseline is likewise streaming throughput with the host not in the loop.

Every swept unroll depth's throughput is recorded in the row ("sweep"), not
just the winner (VERDICT round-4 weak item 6).

Writes build/bench_configs.json and prints one JSON line per config.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

# BENCH_CONFIGS_SMOKE=1: run the exact same code path at tiny geometry (CPU
# viable) - a pre-flight check that a run on the card cannot crash here.
SMOKE = os.environ.get("BENCH_CONFIGS_SMOKE", "") == "1"
OUT = os.path.join(ROOT, "build", "bench_configs_smoke.json" if SMOKE
                   else "bench_configs.json")

REPS = 1 if SMOKE else 3       # queued encodes per timed batch
BATCHES = 1 if SMOKE else 2    # timed batches (best taken)


def main():
    import jax
    import jax.numpy as jnp

    from bench import make_filmic_frames, make_frames
    from fpga_mpeg2_encoder_tpu.models.encoder import encode_gop_scan
    from fpga_mpeg2_encoder_tpu.parallel.dp import encode_gops_batched

    results = []
    int(jnp.int32(1) + jnp.int32(2))    # pre-warm the scalar combiner

    def timed_best(run, inputs, force_scalar, check_ovf):
        """Queue len(inputs)//BATCHES reps per batch (distinct content each),
        force with ONE combined readback, return best per-rep seconds."""
        per_batch = len(inputs) // BATCHES
        best = float("inf")
        for b in range(BATCHES):
            batch_in = inputs[b * per_batch:(b + 1) * per_batch]
            t0 = time.perf_counter()
            outs = [run(x) for x in batch_in]
            force = force_scalar(outs[0])
            for o in outs[1:]:
                force = force + force_scalar(o)
            int(force)
            dt = time.perf_counter() - t0
            best = min(best, dt / per_batch)
            for o in outs:
                check_ovf(o)
        return best

    def run_single(label, w, h, nf, pframes, row_cap, frame_cap, seq_cap,
                   maker=make_frames, unroll=1):
        """Benchmark one geometry; `unroll` may be an int or a tuple of
        candidate scan-step unroll depths (bit-identical output either way) -
        the row records every depth's throughput and which depth won."""
        frames = maker(w, h, nf)
        fy = jnp.asarray(np.stack([f[0] for f in frames]))
        fu = jnp.asarray(np.stack([f[1] for f in frames]))
        fv = jnp.asarray(np.stack([f[2] for f in frames]))
        py = jnp.zeros((h, w), jnp.uint8)
        pc = jnp.zeros((h // 2, w // 2), jnp.uint8)
        fys = [jnp.roll(fy, r, axis=0) for r in range(REPS * BATCHES + 1)]
        jax.block_until_ready(fys)
        unrolls = unroll if isinstance(unroll, tuple) else (unroll,)
        sweep = {}
        best = float("inf")
        best_u = unrolls[0]
        for u in unrolls:
            kw = dict(yr=6, ur=3, q_level=2, row_cap=row_cap,
                      frame_cap=frame_cap, seq_cap=seq_cap, unroll=u)

            def run(y):
                return encode_gop_scan(y, fu, fv, py, pc, pc, jnp.int32(0),
                                       jnp.int32(0), jnp.int32(pframes), **kw)

            out = run(fys[0])           # warm-up (compile) + overflow check
            int(out[4])
            assert not bool(out[7]), f"{label}: overflow (unroll={u})"

            def check(o):
                assert not bool(o[7]), f"{label}: overflow (unroll={u})"

            ubest = timed_best(run, fys[1:], lambda o: o[4], check)
            sweep[str(u)] = round(w * h * nf / ubest / 1e6, 1)
            if ubest < best:
                best, best_u = ubest, u
        mpix = w * h * nf / best / 1e6
        results.append({"metric": label, "value": round(mpix, 1),
                        "unit": "MPixels/s", "vs_baseline": round(mpix / 268, 3),
                        "unroll": best_u, "sweep": sweep})
        print(json.dumps(results[-1]), flush=True)   # progress as rows land

    # Two legitimate one-chip deployment forms for B independent streams:
    #   * "vmap"  - one device-resident batched scan (encode_gops_batched):
    #     wins at small frames, where per-scan-step overhead dominates and
    #     batching fills the chip;
    #   * "seq"   - B independent single-stream scans queued back to back
    #     (steady-state, one combined readback): at big frames each scan
    #     already fills the chip, so the aggregate approaches single-stream
    #     throughput with zero batching tax.  Per-stream bit-exactness is
    #     trivial (same code path).
    # The row records whichever form wins plus both forms' throughputs.
    def run_batched(label, b, w, h, nf, row_cap, frame_cap, seq_cap,
                    unroll=1):
        frames = make_frames(w, h, nf)
        fy1 = np.stack([f[0] for f in frames])
        fu1 = np.stack([f[1] for f in frames])
        fv1 = np.stack([f[2] for f in frames])
        fy = jnp.asarray(np.stack([np.roll(fy1, k, axis=0) for k in range(b)]))
        fu = jnp.asarray(np.stack([fu1] * b))
        fv = jnp.asarray(np.stack([fv1] * b))
        py = jnp.zeros((b, h, w), jnp.uint8)
        pc = jnp.zeros((b, h // 2, w // 2), jnp.uint8)
        z = jnp.zeros((b,), jnp.int32)
        pf = jnp.full((b,), 23, jnp.int32)
        nrolls = REPS * BATCHES + 1
        fys = [jnp.roll(fy, r, axis=1) for r in range(nrolls)]
        jax.block_until_ready(fys)
        unrolls = unroll if isinstance(unroll, tuple) else (unroll,)
        sweep = {}
        best = float("inf")
        best_u, best_form = unrolls[0], "vmap"
        for u in unrolls:
            kw = dict(yr=6, ur=3, q_level=2, row_cap=row_cap,
                      frame_cap=frame_cap, seq_cap=seq_cap, unroll=u)

            def runb(y):
                return [encode_gops_batched(y, fu, fv, py, pc, pc, z, z, pf,
                                            **kw)]

            def runseq(y):
                return [encode_gop_scan(y[k], fu[k], fv[k], py[0], pc[0],
                                        pc[0], jnp.int32(0), jnp.int32(0),
                                        jnp.int32(23), **kw)
                        for k in range(b)]

            for form, fn in (("vmap", runb), ("seq", runseq)):
                def run(y):
                    return fn(y)

                def force(outs):
                    s = jnp.asarray(outs[0][4]).sum()
                    for o in outs[1:]:
                        s = s + jnp.asarray(o[4]).sum()
                    return s

                def check(outs):
                    for o in outs:
                        assert not bool(np.asarray(o[7]).any()), \
                            f"{label}: overflow (unroll={u}, {form})"

                outs = run(fys[0])      # warm-up
                int(force(outs))
                check(outs)
                fbest = timed_best(run, fys[1:], force, check)
                sweep[f"{form}_u{u}"] = round(b * w * h * nf / fbest / 1e6, 1)
                if fbest < best:
                    best, best_u, best_form = fbest, u, form
        mpix = b * w * h * nf / best / 1e6
        results.append({"metric": label, "value": round(mpix, 1),
                        "unit": "MPixels/s",
                        "vs_baseline": round(mpix / 268, 3),
                        "unroll": best_u, "form": best_form, "sweep": sweep})
        print(json.dumps(results[-1]), flush=True)   # progress as rows land

    if SMOKE:
        run_single("smoke_single", 64, 64, 8, 3, 256, 4096, 65536,
                   unroll=(2, 4))
        run_batched("smoke_batched", 2, 64, 64, 4, 256, 4096, 32768,
                    unroll=(2, 4))
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
        for r in results:
            print(json.dumps(r))
        return

    # configs 2-3: the reference testbench geometries (BASELINE configs).
    # Small frames amortise residual per-scan-step cost with DEEP scan
    # chunks (384 CIF frames are still only ~150 MB of staged planes) and
    # multi-frame scan-step unrolling (lets XLA overlap frame n's entropy
    # tail with frame n+1's subsample/ME front; bit-identical).
    run_single("encode_throughput_352x288_ippp", 352, 288, 384, 23,
               1024, 32768, 4194304, unroll=(1, 4, 8))
    run_single("encode_throughput_720x576_ippp", 720, 576, 192, 23,
               2048, 65536, 8388608, unroll=(1, 2, 4))
    # config 4: 1920x1152, pframes_count=255 (one I, then all P)
    run_single("encode_throughput_1920x1152_p255", 1920, 1152, 48, 255,
               4096, 262144, 4194304)
    # filmic-statistics content (natural low-frequency energy + grain):
    # derisks the entropy budget vs real-world material
    run_single("encode_throughput_1920x1152_filmic", 1920, 1152, 48, 23,
               4096, 262144, 4194304, maker=make_filmic_frames)

    run_batched("encode_throughput_8x352x288_aggregate", 8, 352, 288, 48,
                1024, 32768, 524288, unroll=(4, 8))

    # config 5: batched 8-stream 1080p aggregate on one chip
    run_batched("encode_throughput_8x1920x1152_aggregate", 8, 1920, 1152, 12,
                4096, 262144, 1048576, unroll=(1, 2))

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
