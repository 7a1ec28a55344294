"""Device-time profile of one forward+backward bench iteration.

    python profile_trace.py

Traces one `bench.py` iteration (same scene, loss and calibrated compaction
schedule) with `jax.profiler` and prints the top device operations by
summed duration, taken from the GPU stream events of the trace. Knobs:
PROF_SIZE (256), PROF_SPP (16), PROF_DEPTH (5), BENCH_SCENE (spot), and
PROF_DIR (default: traces/ at the repository root). Refuses to run
without a GPU.
"""
import collections
import glob
import gzip
import json
import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench  # noqa: E402
from mafrixraytracing_tpu.utils.cache import REPO_ROOT, enable_compile_cache  # noqa: E402


def main():
    if jax.default_backend() != "gpu":
        print("profile_trace: no GPU", file=sys.stderr)
        return 2
    enable_compile_cache()
    W = H = int(os.environ.get("PROF_SIZE", 256))
    spp = int(os.environ.get("PROF_SPP", 16))
    depth = int(os.environ.get("PROF_DEPTH", 5))
    trace_dir = os.environ.get("PROF_DIR", os.path.join(REPO_ROOT, "traces"))

    cs, name = bench.build_scene(W, H)
    config, _ = bench.calibrated_config(cs.scene, cs.camera, W, H, depth)
    grad_fn = bench.make_grad_fn(cs.scene, cs.camera, W, H, spp, config)
    args = (cs.scene.mat_albedo, cs.scene.light_radiance, cs.scene.tri_v0)
    print("compiling/warmup...", flush=True)
    jax.block_until_ready(grad_fn(*args, jax.random.key(0)))
    print("tracing...", flush=True)
    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir, create_perfetto_trace=True):
        jax.block_until_ready(grad_fn(*args, jax.random.key(1)))

    paths = sorted(glob.glob(f"{trace_dir}/**/perfetto_trace.json.gz",
                             recursive=True), key=os.path.getmtime)
    assert paths, f"no trace under {trace_dir}"
    with gzip.open(paths[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    # device planes are named like "/device:GPU:0"; host threads are not
    pid_names = {e["pid"]: e["args"].get("name", "") for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev_pids = {p for p, n in pid_names.items() if "/device:" in n}
    assert dev_pids, f"no device planes among {sorted(pid_names.values())}"

    by_op = collections.Counter()
    total = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            dur = e.get("dur", 0) / 1e3  # us -> ms
            total += dur
            by_op[e.get("name", "?")] += dur

    print(f"\ntotal device time: {total:.1f} ms ({name}, {W}x{H} @ {spp} spp "
          f"depth {depth}, fwd+bwd; {jax.devices()[0].device_kind})\n")
    print(f"{'ms':>10}  {'%':>5}  op")
    for op, ms in by_op.most_common(60):
        print(f"{ms:10.2f}  {100 * ms / max(total, 1e-9):5.1f}  {op[:140]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
