"""Weak-scaling harness: samples/s efficiency at 1..N shards.

BASELINE requires "samples/s scaling efficiency measured at 1 chip,
1 host, and N>=2 hosts (>=85%)".  This harness runs the sharded
wideband chain at a fixed per-shard block size over growing meshes and
reports throughput + efficiency vs the 1-shard baseline.  On real
devices it measures halo-exchange overhead directly; on the virtual
CPU mesh it validates the mechanics (the dryrun path).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.parallel import sharding as sh
from comms_tpu.parallel import wideband

__all__ = ["weak_scaling"]


def weak_scaling(taps, per_shard: int = 1 << 20,
                 shard_counts: Optional[Sequence[int]] = None,
                 iters: int = 10, reps: int = 3) -> list[dict]:
    """Run the wideband FM chain at each shard count; per-shard work is
    constant (weak scaling).  Returns one record per mesh size with
    Gsps and efficiency vs the smallest mesh."""
    n_avail = len(jax.devices())
    if shard_counts is None:
        shard_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    results = []
    base_per_shard_gsps = None
    for n in shard_counts:
        mesh = sh.time_mesh(n)
        block = per_shard * n
        cfg = wideband.WidebandConfig(taps, block=block, dec1=5, dec2=5)
        step = wideband.make_sharded_step(cfg, mesh)
        state = wideband.init_state(cfg)
        rng = np.random.default_rng(0)
        pairs = jnp.asarray(rng.normal(size=(block, 2)).astype(np.float32))

        (audio, freq), state = step(state, pairs)
        jax.block_until_ready(audio)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            s = state
            for _ in range(iters):
                (audio, freq), s = step(s, pairs)
            jax.block_until_ready(audio)
            best = min(best, (time.perf_counter() - t0) / iters)
        gsps = block / best / 1e9
        per_shard_gsps = gsps / n
        if base_per_shard_gsps is None:
            base_per_shard_gsps = per_shard_gsps
        results.append({
            "shards": n,
            "block": block,
            "gsps": round(gsps, 4),
            "per_shard_gsps": round(per_shard_gsps, 4),
            "efficiency": round(per_shard_gsps / base_per_shard_gsps, 3),
        })
    return results


def main(argv=None):
    """One-command weak-scaling run: ``python -m comms_tpu.parallel.
    scaling [--out FILE] [--per-shard N] [--iters N] [--reps N]``.

    On a real pod this produces the BASELINE >= 85% efficiency record;
    on the virtual CPU mesh it validates the mechanics (the artifact
    is labeled with the platform so the two are never confused).
    """
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    ap.add_argument("--per-shard", type=int, default=102400)  # % 25 == 0
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "native"],
                    help="cpu = virtual 8-device mesh (mechanics); "
                         "native = whatever accelerators are attached")
    args = ap.parse_args(argv)

    import jax

    if args.platform == "cpu":
        # The device-count flag must be set before backend init.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")

    from comms_tpu.models.fm_receiver import FM_LPF_TAPS

    platform = jax.devices()[0].platform
    results = weak_scaling(FM_LPF_TAPS, per_shard=args.per_shard,
                           iters=args.iters, reps=args.reps)
    artifact = {
        "platform": platform,
        "devices": len(jax.devices()),
        "device_kind": jax.devices()[0].device_kind,
        "per_shard": args.per_shard,
        "note": ("MECHANICS ONLY: virtual CPU mesh — validates the "
                 "collective structure end-to-end, NOT link bandwidth. "
                 "All virtual devices time-share this host's single "
                 "physical core, so 'efficiency' here measures core "
                 "contention (expect ~1/shards), not halo overhead; "
                 "run with --platform native on a pod for the "
                 "BASELINE >=85% efficiency record"
                 ) if platform == "cpu" else "hardware measurement",
        "results": results,
    }
    for rec in results:
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
