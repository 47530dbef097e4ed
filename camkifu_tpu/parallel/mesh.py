"""Multi-chip scaling: shard the pipeline over a device mesh.

The reference is a single-process desktop app with no distributed backend
(SURVEY §2.4); the device-native scaling story is data parallelism over
independent video streams (BASELINE config 5: N concurrent boards). Streams
shard over a 1-D 'stream' mesh axis; within a stream, frames batch on the
time axis. XLA inserts no collectives for the vision path (streams are
independent) — the links between cards stay free for the neural finder's
dp gradient psum (parallel.train — added with sf_neural).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from camkifu_tpu import pipeline
from camkifu_tpu.config import cvconf, guiconf


#: HLO op names of cross-device collectives. The stream paths must compile
#: to none of them: streams are independent.
COLLECTIVE_OPS = ("all-reduce", "all-gather", "all-to-all",
                  "collective-permute", "collective-broadcast",
                  "reduce-scatter", "ragged-all-to-all")


def collective_ops(hlo_text: str) -> list[str]:
    """The collective ops that appear in a compiled module's HLO text."""
    return [op for op in COLLECTIVE_OPS if op in hlo_text]


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (stream, ...) arrays: split the leading axis over chips."""
    return NamedSharding(mesh, P("stream"))


def _read_streams_local(frames, corners, *, gsize, zone):
    # Each stream's corners are FIXED, so warp per stream with the fixed-
    # corner path (indices shared across the stream's frames) — routing the
    # repeated corners through the generic per-frame chunked warp paid its
    # median/subpixel machinery for nothing and dominated c5. The classify
    # then runs on the flat (streams·B) batch rather than a vmap of
    # batches.
    from camkifu_tpu.ops.warp import warp_batch_fixed
    from camkifu_tpu.stone import sf_clustering

    with jax.default_matmul_precision("float32"):
        s, b = frames.shape[0], frames.shape[1]
        scale = 1.0 / 255.0 if frames.dtype == jnp.uint8 else 1.0
        # lax.map (sequential over the local streams), NOT vmap: a vmapped
        # warp batches distinct gather-index sets, which hit a gather
        # cliff on the first accelerator this ran on; each map step's
        # gather shares its indices across the stream's frames. The premise
        # is unmeasured on the GPU (ROADMAP A5, C3).
        canon = jax.lax.map(
            lambda fc: warp_batch_fixed(fc[0], fc[1], gsize, zone),
            (frames, corners)) * scale
        flat = canon.reshape((s * b,) + canon.shape[2:])
        labels, conf = jax.vmap(
            lambda c: sf_clustering.classify_canonical(c, gsize, zone))(flat)
        g = labels.shape[-1]
        return labels.reshape(s, b, g, g), conf.reshape(s, b, g, g)


@functools.partial(jax.jit, static_argnames=("gsize", "zone"),
                   donate_argnums=())
def _read_all_streams(frames, corners, gsize, zone):
    """Single-device c5 entry (bench): all streams local, no mesh."""
    return _read_streams_local(frames, corners, gsize=gsize, zone=zone)


#: (mesh, gsize, zone) → jitted shard_map of _read_streams_local, memoized
#: for the same reason as _track_fns below.
_read_fns: dict = {}


def _read_fn(mesh: Mesh, gsize: int, zone: int):
    key = (mesh, gsize, zone)
    fn = _read_fns.get(key)
    if fn is None:
        spec = P("stream")
        fn = _read_fns[key] = jax.jit(jax.shard_map(
            functools.partial(_read_streams_local, gsize=gsize, zone=zone),
            mesh=mesh, in_specs=(spec, spec), out_specs=spec,
            check_vma=False))
    return fn


def multistream_read(mesh: Mesh, frames: jnp.ndarray, corners: jnp.ndarray,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size):
    """Classify frames of N independent streams, sharded over the mesh.

    frames: (n_streams, B, H, W, 3) uint8; corners: (n_streams, 4, 2).
    Returns (labels (n_streams, B, g, g), confidence (n_streams, B, g, g)),
    sharded the same way (results stay on their chip until fetched).

    shard_map, not plain jit: the local body lax.maps over streams, and
    under plain jit the SPMD partitioner cannot keep a sequential loop over
    a sharded axis device-local — it inserted an ALL-GATHER of the whole
    frame tensor (caught by the dryrun's compiled-HLO zero-collectives
    assertion, r4). shard_map makes each chip loop over its LOCAL streams
    only, which is the design doc/SCALING.md claims.
    """
    sh = stream_sharding(mesh)
    frames = jax.device_put(frames, sh)
    corners = jax.device_put(corners, sh)
    with mesh:
        return _read_fn(mesh, gsize, zone)(frames, corners)


@functools.partial(jax.jit, static_argnames=("gsize", "zone"))
def _meta_all_streams(states, frames, corners, gsize, zone):
    from camkifu_tpu.stone import sf_meta

    def per_stream(st, f, c):
        return sf_meta.read_batch(st, f, c, gsize=gsize, zone=zone)

    return jax.vmap(per_stream)(states, frames, corners)


def multistream_init_states(n_streams: int, gsize: int = guiconf.gsize):
    """Stacked SfMeta scan states, one per stream (leading stream axis)."""
    from camkifu_tpu.stone import sf_meta

    one = sf_meta.init_state(gsize=gsize)
    return jax.tree.map(
        lambda leaf: jnp.broadcast_to(leaf, (n_streams,) + leaf.shape), one)


def _track_all_streams(states, frames, seeds, lenses=None, *,
                       gsize, zone):
    from camkifu_tpu.stone import sf_meta

    # lax.map (sequential over local streams), NOT vmap: each stream's
    # fused tracker re-rectifies on its own running seed — vmap would batch
    # distinct gather-index sets, while each map step's chunk-shared gather
    # vectorizes across the stream's frames. Same unmeasured premise as
    # _read_streams_local (ROADMAP C3).
    if lenses is None:
        return jax.lax.map(
            lambda sfs: sf_meta.track_read_batch(
                sfs[0], sfs[1], sfs[2], gsize=gsize, zone=zone),
            (states, frames, seeds))
    # Per-stream lens models (different cameras): a stacked Lens pytree
    # with a leading stream axis, sharded/mapped like every other operand.
    return jax.lax.map(
        lambda sfs: sf_meta.track_read_batch(
            sfs[0], sfs[1], sfs[2], gsize=gsize, zone=zone, lens=sfs[3]),
        (states, frames, seeds, lenses))


#: (mesh, gsize, zone) → jitted shard_map of _track_all_streams. jax.jit
#: caches by callable identity, so building the shard_map wrapper inside
#: multistream_track_read would re-trace the whole fused tracker on every
#: batch; the memo restores the once-per-config compile the module-level
#: @jit entry points get for free.
_track_fns: dict = {}


def _track_fn(mesh: Mesh, gsize: int, zone: int, with_lenses: bool = False):
    key = (mesh, gsize, zone, with_lenses)
    fn = _track_fns.get(key)
    if fn is None:
        spec = P("stream")
        n_in = 4 if with_lenses else 3
        # check_vma off: the tracker's lax.scan carries bootstrap from
        # replicated constants (zeros) but become stream-varying after one
        # step, which the varying-manual-axes analysis rejects even though
        # every stream is fully independent (no cross-device communication
        # exists for it to validate).
        fn = _track_fns[key] = jax.jit(jax.shard_map(
            functools.partial(_track_all_streams, gsize=gsize, zone=zone),
            mesh=mesh, in_specs=(spec,) * n_in, out_specs=spec,
            check_vma=False))
    return fn


def multistream_track_read(mesh: Mesh, states, frames: jnp.ndarray,
                           seeds: jnp.ndarray,
                           gsize: int = guiconf.gsize,
                           zone: int = cvconf.zone_size, lenses=None):
    """Config 4 × config 5: the FUSED tracking engine (per-frame board
    measurement + rectification + classification + vote scan) over N
    independent *handheld* streams, sharded over the mesh.

    Unlike multistream_read/multistream_read_meta, every stream carries a
    live tracker: its seed quad re-anchors at its own last frame each call.
    shard_map (not plain jit) makes the placement explicit: each chip loops
    only over its LOCAL streams, so no cross-chip traffic exists and the
    per-stream gathers stay chunk-shared (the fast shape).

    states: stacked MetaState (multistream_init_states); frames:
    (n_streams, B, H, W, 3); seeds: (n_streams, 4, 2) — each stream's last
    detection or previous new_seed. lenses: optional stacked ops/lens.Lens
    (each leaf (n_streams,)) — per-stream radial distortion models, since
    independent streams come from different physical cameras.
    Returns (new_states, labels (S, B, g, g), conf, agitation (S, B),
    corners (S, B, 4, 2), sharpness (S, B), align (S, B),
    new_seeds (S, 4, 2)), all stream-sharded.
    """
    sh = stream_sharding(mesh)
    states = jax.tree.map(lambda leaf: jax.device_put(leaf, sh), states)
    frames = jax.device_put(frames, sh)
    seeds = jax.device_put(seeds, sh)
    with mesh:
        if lenses is None:
            return _track_fn(mesh, gsize, zone)(states, frames, seeds)
        lenses = jax.tree.map(
            lambda leaf: jax.device_put(jnp.asarray(leaf), sh), lenses)
        return _track_fn(mesh, gsize, zone, True)(states, frames, seeds,
                                                  lenses)


def multistream_read_meta(mesh: Mesh, states, frames: jnp.ndarray,
                          corners: jnp.ndarray,
                          gsize: int = guiconf.gsize,
                          zone: int = cvconf.zone_size):
    """Config 5 with full temporal tracking: each stream carries its own
    SfMeta vote/background state, sharded with its frames over the mesh.

    states: stacked MetaState pytree (from multistream_init_states);
    frames: (n_streams, B, H, W, 3); corners: (n_streams, 4, 2).
    Returns (new_states, labels (S, B, g, g), conf, agitation (S, B)).
    """
    sh = stream_sharding(mesh)
    states = jax.tree.map(lambda leaf: jax.device_put(leaf, sh), states)
    frames = jax.device_put(frames, sh)
    corners = jax.device_put(corners, sh)
    with mesh:
        return _meta_all_streams(states, frames, corners, gsize, zone)
