"""Neural stone classifier: a small CNN over intersection patches.

Parity: the dev-branch ``sf_neural`` (SURVEY §2.1) — a Keras CNN classifying
intersection patches B/W/E from labeled samples, with tooling to harvest
training patches. Device-first: flax/optax, bf16 matmuls, batched
over all 361 intersections of many frames at once, orbax checkpoints
(SURVEY §5: orbax enters scope with the neural finder's weights).

flax and orbax are imported only where the net is built or a checkpoint is
read or written, so the finder registry and the classical pipeline load
without them.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax

from camkifu_tpu.config import cvconf

NUM_CLASSES = 3   # 0=E, 1=B, 2=W


@functools.cache
def _patchnet_class():
    import flax.linen as nn

    class PatchNet(nn.Module):
        """Tiny CNN: (z, z, 3) patch → 3-class logits. Compute in bf16,
        params and logits in f32."""

        features: int = 32

        @nn.compact
        def __call__(self, x):
            x = x.astype(jnp.bfloat16)
            x = nn.Conv(self.features, (3, 3), padding="SAME",
                        dtype=jnp.bfloat16)(x)
            x = nn.relu(x)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
            x = nn.Conv(2 * self.features, (3, 3), padding="SAME",
                        dtype=jnp.bfloat16)(x)
            x = nn.relu(x)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
            x = x.reshape((x.shape[0], -1))
            x = nn.Dense(4 * self.features, dtype=jnp.bfloat16)(x)
            x = nn.relu(x)
            x = nn.Dense(NUM_CLASSES, dtype=jnp.bfloat16)(x)
            return x.astype(jnp.float32)

    return PatchNet


def PatchNet(features: int = 32):
    """The patch classifier module (a flax ``nn.Module`` instance)."""
    return _patchnet_class()(features=features)


def init_params(rng, zone: int = cvconf.zone_size):
    model = PatchNet()
    params = model.init(rng, jnp.zeros((1, zone, zone, 3), jnp.float32))
    return model, params


def loss_fn(params, model, patches, labels):
    logits = model.apply(params, patches)
    loss = optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean()
    acc = (jnp.argmax(logits, -1) == labels).mean()
    return loss, acc


# ---------------------------------------------------------------------------
# Dataset harvesting (synthetic games — the labeled-patch tooling).
# ---------------------------------------------------------------------------

def harvest_patches(n_boards: int = 40, frame_hw=(720, 1280), seed: int = 0,
                    zone: int = cvconf.zone_size):
    """Render boards with known labels → (patches (N, z, z, 3) f32, labels).

    The reference harvested patches from videos + manual labels; the
    synthetic renderer gives unlimited labeled data for free (SURVEY §4).
    """
    from camkifu_tpu.ops.color import to_float
    from camkifu_tpu.ops.warp import warp_to_canonical
    from camkifu_tpu.ops.zones import extract_zones
    from camkifu_tpu.utils import synth

    rng = np.random.default_rng(seed)
    palettes = sorted(synth.PALETTES)
    all_patches, all_labels = [], []
    for b in range(n_boards):
        labels = np.zeros((19, 19), np.int8)
        n = int(rng.integers(0, 300))
        if n:
            idx = rng.choice(361, n, replace=False)
            labels.flat[idx[::2]] = 1
            labels.flat[idx[1::2]] = 2
        persp = float(rng.uniform(0.03, 0.30))
        corners = synth.default_corners(frame_hw, perspective=persp)
        # Cycle wood palettes and sample the adversarial-eval degradation
        # ranges (lighting gradient, defocus, shadow, the r3 'real'
        # additions: wood-grain texture, vignetting, and the r5 tier-3
        # hazards: specular GLARE saturating stone tops — white pixels on
        # black stones, the classical ensemble's hardest measured
        # classification case — and shot/read sensor noise) so the voter
        # is not tuned to one board look or to clean studio frames.
        frame, _ = synth.render_frame(
            labels, corners, frame_hw, seed=int(rng.integers(1 << 30)),
            stone_jitter=0.06, palette=palettes[b % len(palettes)],
            light_gradient=float(rng.uniform(0.0, 0.35)),
            blur_sigma=float(rng.choice([0.0, 0.0, 0.8, 1.4])),
            shadow=float(rng.choice([0.0, 0.0, 0.15, 0.25])),
            wood_texture=float(rng.choice([0.0, 0.08, 0.12])),
            vignette=float(rng.choice([0.0, 0.0, 0.22])),
            glare=float(rng.choice([0.0, 0.0, 0.4, 0.6])),
            shot_noise=float(rng.choice([0.0, 0.0, 0.3, 0.5])))
        # Warp through PERTURBED corners (small similarity error: rotation
        # up to ~1.2°, a few px of shift): the runtime feeds the classifier
        # canonicals with exactly this kind of residual (tracking measures
        # per chunk; within-chunk rotation is corrected only at re-anchor),
        # so train on it rather than on perfectly-centered zones.
        wc = corners
        if rng.random() < 0.5:
            th = float(rng.normal(0.0, 0.012))
            ctr = corners.mean(axis=0)
            rot = np.array([[np.cos(th), -np.sin(th)],
                            [np.sin(th), np.cos(th)]], np.float32)
            wc = (ctr + (corners - ctr) @ rot.T
                  + rng.normal(0.0, 1.5, (1, 2))).astype(np.float32)
        canon = warp_to_canonical(to_float(jnp.asarray(frame)),
                                  jnp.asarray(wc))
        zones = np.asarray(extract_zones(canon, 19, zone))
        all_patches.append(zones.reshape(-1, zone, zone, 3))
        all_labels.append(labels.reshape(-1).astype(np.int32))
    return (np.concatenate(all_patches).astype(np.float32),
            np.concatenate(all_labels))


# ---------------------------------------------------------------------------
# Single-chip training (multi-chip: camkifu_tpu.parallel.train).
# ---------------------------------------------------------------------------

def train(patches, labels, epochs: int = 3, batch: int = 2048,
          lr: float = 3e-3, seed: int = 0, log=None):
    """Train PatchNet; returns (model, params, final accuracy)."""
    model, params = init_params(jax.random.PRNGKey(seed))
    tx = optax.adamw(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, px, ly):
        (loss, acc), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, model, px, ly)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    n = len(patches)
    rng = np.random.default_rng(seed)
    acc = 0.0
    for epoch in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            sel = order[i:i + batch]
            params, opt_state, loss, acc = step(
                params, opt_state, jnp.asarray(patches[sel]),
                jnp.asarray(labels[sel]))
        if log:
            log(f"epoch {epoch}: loss {float(loss):.4f} acc {float(acc):.4f}")
    return model, params, float(acc)


# ---------------------------------------------------------------------------
# Checkpointing (orbax).
# ---------------------------------------------------------------------------

DEFAULT_CKPT = os.path.expanduser("~/.camkifu_tpu/sf_neural_ckpt")


def save_params(params, path: str = DEFAULT_CKPT) -> None:
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.expanduser(path))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, jax.device_get(params), force=True)
    ckptr.wait_until_finished()


def load_params(path: str = DEFAULT_CKPT):
    """Load the neural classifier weights, or None if no checkpoint exists.

    Only a user-trained checkpoint (``cktrain``) participates: two ablation
    sweeps (PERF.md — r2 flat-shaded synth and r3 realism synth, the latter
    with the net retrained on that domain) showed the classical ensemble
    already saturates every measurable config with and without the voter,
    so no pretrained checkpoint is shipped — it would silently slow every
    run while changing nothing. The model + trainer stay for footage whose
    conditions the classical stack does not cover (train there, drop the
    checkpoint in DEFAULT_CKPT, and SfMeta picks it up as a third voter).

    A missing checkpoint imports nothing; a present one needs flax and
    orbax, and their absence raises ImportError.
    """
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        return None
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    _, abstract = init_params(jax.random.PRNGKey(0))
    abstract = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), abstract)
    return ckptr.restore(path, abstract)


def main(argv=None) -> int:
    """cktrain — train the neural stone classifier and save its checkpoint.

    Once a checkpoint exists, SfNeural uses it directly and SfMeta picks it
    up as a third voter (opt-in by training — an untrained net never
    participates).
    """
    import argparse

    from camkifu_tpu.utils import device, jaxcache

    jaxcache.enable()
    device.check_entry("cktrain")
    ap = argparse.ArgumentParser(prog="cktrain")
    ap.add_argument("--boards", type=int, default=48,
                    help="synthetic boards to harvest patches from")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = auto (dataset/12, clamped to [256, 2048]) so "
                         "small harvests still get enough optimizer steps")
    ap.add_argument("--out", default=DEFAULT_CKPT)
    ap.add_argument("--sharded", action="store_true",
                    help="dp+tp training over all local devices")
    args = ap.parse_args(argv)

    print(f"harvesting patches from {args.boards} boards…")
    patches, labels = harvest_patches(n_boards=args.boards)
    if not args.batch:
        args.batch = int(np.clip(len(patches) // 12, 256, 2048))
    print(f"{len(patches)} patches; training (batch {args.batch})…")
    if args.sharded:
        from camkifu_tpu.parallel import train as ptrain

        params, acc = ptrain.train_sharded(patches, labels,
                                           epochs=args.epochs,
                                           batch=args.batch, log=print)
        params = jax.device_get(params)
    else:
        _, params, acc = train(patches, labels, epochs=args.epochs,
                               batch=args.batch, log=print)
    save_params(params, args.out)
    print(f"accuracy {acc:.4f}; checkpoint saved to {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
