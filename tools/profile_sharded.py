#!/usr/bin/env python3
"""Single-chip shard_map overhead profile (VERDICT r03 item 7).

The production scale-out layout (README "2-D stream x slice mesh") has had
zero timing data: this tool measures, on whatever devices JAX exposes,

* the plain single-chip frame step (models/encoder.encode_frame_core), vs
* the SAME step under shard_map on a 1-device `slice` mesh (pure shard_map +
  halo-exchange machinery overhead - the collectives are self-sends), vs
* if >1 real device exists, the n-device slice mesh (real ICI halos).

Times per-frame wall clock with bench.py's honesty rules (content varied per
rep, completion forced by scalar readback).  Prints one JSON line per row.
Run on the cards: `python tools/profile_sharded.py`; PROF_NF overrides frame count.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def main():
    import jax

    import jax.numpy as jnp

    from bench import make_frames
    from fpga_mpeg2_encoder_tpu.models.encoder import (
        DEFAULT_FRAME_CAP, DEFAULT_ROW_CAP, encode_frame_core)
    from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh
    from fpga_mpeg2_encoder_tpu.parallel.spatial import (
        make_sharded_frame_encoder, sharded_frame_shardings)

    w = int(os.environ.get("PROF_W", "1920"))
    h = int(os.environ.get("PROF_H", "1152"))
    nf = int(os.environ.get("PROF_NF", "12"))
    kw = dict(yr=6, ur=3, q_level=2)
    frames = make_frames(w, h, nf)
    ys = [jnp.asarray(f[0]) for f in frames]
    us = [jnp.asarray(f[1]) for f in frames]
    vs = [jnp.asarray(f[2]) for f in frames]
    z = jnp.zeros((h, w), jnp.uint8)
    zc = jnp.zeros((h // 2, w // 2), jnp.uint8)
    jax.block_until_ready([ys, us, vs, z, zc])

    def timed(label, step, place):
        prev = (place(z), place(zc), place(zc))
        out = step(place(ys[0]), place(us[0]), place(vs[0]), *prev,
                   jnp.int32(0), jnp.int32(0))
        int(out[4])                      # force completion (warm-up)
        t0 = time.perf_counter()
        for fi in range(1, nf):
            out = step(place(ys[fi]), place(us[fi]), place(vs[fi]), *prev,
                       jnp.int32(fi), jnp.int32(fi))
            prev = out[:3]
        int(out[4])
        dt = (time.perf_counter() - t0) / (nf - 1)
        mpix = w * h / dt / 1e6
        print(json.dumps({"metric": label, "ms_per_frame": round(dt * 1e3, 2),
                          "value": round(mpix, 1), "unit": "MPixels/s"}))
        return dt

    def plain(y, u, v, py, pu, pv, i_f, fno):
        return encode_frame_core(y, u, v, py, pu, pv, i_f, fno,
                                 row_cap=DEFAULT_ROW_CAP,
                                 frame_cap=DEFAULT_FRAME_CAP, **kw)

    plain_j = jax.jit(plain)
    t_plain = timed(f"frame_step_plain_{w}x{h}", plain_j, lambda x: x)

    mesh1 = make_mesh(1, axis="slice")
    enc1 = make_sharded_frame_encoder(mesh1, h, w, **kw)
    sh1, _ = sharded_frame_shardings(mesh1)
    t_sh1 = timed(f"frame_step_shardmap1_{w}x{h}", enc1,
                  lambda x: jax.device_put(x, sh1))
    print(json.dumps({"metric": "shardmap_overhead_1dev_pct",
                      "value": round(100 * (t_sh1 / t_plain - 1), 1),
                      "unit": "%"}))

    nd = len(jax.devices())
    if nd > 1:
        n = min(nd, (h // 16) & -(h // 16))  # largest power-of-2-ish divisor
        while (h // 16) % n:
            n -= 1
        meshn = make_mesh(n, axis="slice")
        encn = make_sharded_frame_encoder(meshn, h, w, **kw)
        shn, _ = sharded_frame_shardings(meshn)
        timed(f"frame_step_shardmap{n}_{w}x{h}", encn,
              lambda x: jax.device_put(x, shn))


if __name__ == "__main__":
    main()
