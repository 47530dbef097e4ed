"""GPU bring-up probe: the edge stage's share of full re-detection, and the
``_solve8`` constant-folding check. Prints one JSON object.

1. Edge share. ``bf_auto.detect_batch`` on 64 distinct 1080p frames is
   timed end to end, and the parts of the edge stack it runs on the 2·64
   detection-resolution maps (blur + Sobel + NMS magnitude, the percentile
   threshold, hysteresis) are timed alone, with the profiler off. A kernel
   for the magnitude front end can move full re-detection by at most the
   magnitude's share. detect_batch is also traced with ``jax.profiler``
   and device time is summed per name scope (``tf_op``). XLA launches a
   module's kernels as one CUDA graph unless
   ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` turns that off; only then
   do kernel events carry their op's scope.
2. ``_solve8`` on compile-time constants: ``jit(vmap(_solve8))`` on the
   constant square→square DLT system, whose exact solution is the identity
   homography, on the default device and on the CPU. An XLA constant
   folder once miscompiled this case; the check guards against it.

Run: ``python tools/bringup_probe.py TRACE_DIR [HLO_DIR]`` (one GPU). The
trace goes to TRACE_DIR.
With ``XLA_FLAGS="--xla_gpu_enable_command_buffer= --xla_dump_to=HLO_DIR
--xla_dump_hlo_as_text"`` and ``hlo_dir`` = HLO_DIR, every kernel is
attributed to the name scopes of the ops its fusion runs.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _device_events(path: str):
    """(name, start_ns, dur_ns, stats) of every event on a device plane."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                out.append((ev.name, ev.start_ns, ev.duration_ns,
                            {k: str(v) for k, v in dict(ev.stats).items()}))
    return out


def _busy_ns(events) -> float:
    """Union of the events' intervals."""
    spans = sorted((s, s + d) for _, s, d, _ in events)
    total, end = 0.0, -np.inf
    for s, e in spans:
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _fusion_op_names(hlo_text: str) -> dict:
    """{instruction name: op names of the ops it runs} from optimized HLO
    text: a fusion runs the ops of the computation it calls."""
    import re

    comp_ops, calls, own = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head and "=" not in line.split("{")[0]:
            comp = head.group(1)
            comp_ops.setdefault(comp, [])
            continue
        inst = re.match(r"^\s*(?:ROOT )?%?([\w.\-]+) = ", line)
        if not inst:
            continue
        name = re.search(r'op_name="([^"]*)"', line)
        if comp is not None and name:
            comp_ops[comp].append(name.group(1))
        called = re.search(r"calls=%?([\w.\-]+)", line)
        if called:
            calls[inst.group(1)] = called.group(1)
        if name:
            own[inst.group(1)] = [name.group(1)]
    return {i: comp_ops.get(calls.get(i), []) or own.get(i, [])
            for i in set(calls) | set(own)}


def hlo_attribution(events, ops: dict, scope: str) -> dict:
    """Device ns of kernels whose fusion holds ops of ``scope``: all of
    them (lower bound), any of them (upper bound), and kernels the HLO
    does not name. ``ops`` is ``_fusion_op_names`` of the module."""
    lo = hi = unknown = total = 0.0
    for _, _, d, st in events:
        total += d
        names = ops.get(st.get("hlo_op", ""))
        if not names:
            unknown += d
            continue
        hit = [scope in n for n in names]
        lo += d if all(hit) else 0.0
        hi += d if any(hit) else 0.0
    return {"total": total, "all_ops_in_scope": lo, "any_op_in_scope": hi,
            "unmatched": unknown}


def scope_breakdown(events, ops: dict, depth: int = 3) -> dict:
    """Device ns per name scope, to ``depth`` levels below the module's
    jit: each kernel counts under the scope most of its fusion's ops carry;
    kernels the HLO does not name count under ``(unmatched) <kernel>``."""
    from collections import Counter

    out = Counter()
    for name, _, d, st in events:
        names = ops.get(st.get("hlo_op", ""))
        if not names:
            out[f"(unmatched) {name[:40]}"] += d
            continue
        scopes = Counter("/".join(n.split("/")[1:depth + 1]) or "(unscoped)"
                         for n in names)
        out[scopes.most_common(1)[0][0]] += d
    return dict(out.most_common(25))


def edge_share(trace_dir: str, n: int = 64, hlo_dir: str | None = None
               ) -> dict:
    import jax

    import chip_smoke
    from camkifu_tpu.board import bf_auto
    from camkifu_tpu.ops import edges

    frames, _, _ = chip_smoke.still_frames(n, chip_smoke.HD, seed=9)
    fr = jax.device_put(frames)
    fence = lambda x: np.asarray(jax.tree.leaves(x)[0])

    def best(fn, reps=5, tries=3):
        # block_until_ready, not a fetch: fetching a 33 MB edge map to the
        # host would be timed with the kernels.
        jax.block_until_ready(fn())
        b = np.inf
        for _ in range(tries):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            jax.block_until_ready(out)
            b = min(b, (time.perf_counter() - t0) / reps)
        return b

    import jax.numpy as jnp

    res = {"detect_batch_s": best(lambda: bf_auto.detect_batch(fr)[0])}
    maps = jax.device_put(np.random.default_rng(0).random(
        (2 * n, 256, 256), np.float32))
    mag_fn = jax.jit(jax.vmap(lambda g: edges._magnitude(g, 1.4)))
    mags = mag_fn(maps)
    pct_fn = jax.jit(lambda m: jnp.percentile(m[:, ::2, ::2], 99.5,
                                              axis=(1, 2)))
    ref = pct_fn(mags)
    hys_fn = jax.jit(jax.vmap(lambda m, r: edges.hysteresis(
        m, 0.15 * r, 0.4 * r, 4)))
    parts = {"edge_stack": (jax.jit(edges.edge_map_batch), (maps,)),
             "magnitude": (mag_fn, (maps,)), "percentile": (pct_fn, (mags,)),
             "hysteresis": (hys_fn, (mags, ref))}
    for name, (fn, args) in parts.items():
        res[f"{name}_alone_s"] = best(lambda: fn(*args))
        res[f"{name}_share"] = res[f"{name}_alone_s"] / res["detect_batch_s"]

    fence(bf_auto.detect_batch(fr)[0])
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            fence(bf_auto.detect_batch(fr)[0])
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[-1]
    evs = _device_events(path)
    res["trace_command_buffers"] = "command_buffer=" not in os.environ.get(
        "XLA_FLAGS", "")
    res["trace_kernel_ns"] = float(sum(d for _, _, d, _ in evs))
    res["trace_busy_ns"] = _busy_ns(evs)
    res["trace_kernels"] = len(evs)
    dumps = glob.glob(os.path.join(hlo_dir or trace_dir, "*detect_batch_"
                                   "fused*after_optimizations.txt"))
    if dumps:
        with open(dumps[-1]) as fh:
            ops = _fusion_op_names(fh.read())
        res["hlo_edge_ns"] = hlo_attribution(evs, ops, "/edge_map/")
        res["hlo_scope_ns"] = scope_breakdown(evs, ops)
    top = {}
    for name, _, d, _ in evs:
        top[name] = top.get(name, 0.0) + d
    res["trace_top_kernels"] = sorted(top.items(), key=lambda kv: -kv[1])[:15]
    with open(os.path.join(trace_dir, "sample_events.json"), "w") as fh:
        json.dump(evs[:200], fh, indent=1)
    return res


def solve8_on_constants() -> dict:
    import jax
    import jax.numpy as jnp

    from camkifu_tpu.ops import warp

    sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    x, y = sq[:, 0], sq[:, 1]
    z, o = np.zeros(4, np.float32), np.ones(4, np.float32)
    a = np.concatenate([np.stack([x, y, o, z, z, z, -x * x, -x * y], 1),
                        np.stack([z, z, z, x, y, o, -y * x, -y * y], 1)])
    b = np.concatenate([x, y])
    want = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.float32)
    out = {}
    for name, dev in (("default", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            aa = jnp.broadcast_to(jnp.asarray(a), (4, 8, 8))
            bb = jnp.broadcast_to(jnp.asarray(b), (4, 8))
            h = np.asarray(jax.jit(lambda: jax.vmap(warp._solve8)(aa, bb))())
        out[name] = {"max_err": float(np.abs(h - want).max()),
                     "first": h[0].tolist()}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__.split("Run: ")[1].split("\n")[0])
    trace_dir = argv[0]
    hlo_dir = argv[1] if len(argv) > 1 else None
    from camkifu_tpu.utils import device, jaxcache

    jaxcache.enable()
    dev = device.describe()
    rep = {"device": dev, "solve8_on_constants": solve8_on_constants(),
           "edge": edge_share(trace_dir, hlo_dir=hlo_dir)}
    if dev["platform"] == "gpu":
        rep["card"] = device.card_name_and_power_limit()
    print(json.dumps(rep, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
