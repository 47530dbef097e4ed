"""Multi-chip training of the neural stone classifier.

The training step shards over a 2-D ('data', 'model') mesh:
- **dp**: the patch batch splits over 'data'; XLA inserts the gradient
  psum across data-parallel replicas (NCCL over NVLink on GPUs).
- **tp**: the two Dense layers shard over 'model' (kernel columns of the
  first, kernel rows of the second — Megatron-style pairing, so the forward
  pass needs a single psum at the second Dense's output and no resharding
  in between).

Conv layers are tiny and stay replicated — sharding them would move more
bytes between devices than they cost to compute (shard where
the arithmetic intensity justifies the collective).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from camkifu_tpu.models import neural


def make_mesh(devices=None, model_parallel: int = 2) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    mp = model_parallel if n % model_parallel == 0 and n >= model_parallel \
        else 1
    return Mesh(devices.reshape(n // mp, mp), axis_names=("data", "model"))


def param_sharding(params, mesh: Mesh):
    """PartitionSpecs: Dense_0 kernel column-sharded, Dense_1 kernel
    row-sharded over 'model'; everything else replicated."""

    def spec(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        if "Dense_0" in names and leaf.ndim == 2:
            return P(None, "model")
        if "Dense_0" in names and leaf.ndim == 1:
            return P("model")
        if "Dense_1" in names and leaf.ndim == 2:
            return P("model", None)
        return P()

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec(path, leaf)), params)


def make_train_step(mesh: Mesh, tx, model=None):
    model = model or neural.PatchNet()

    @jax.jit
    def train_step(params, opt_state, patches, labels):
        (loss, acc), grads = jax.value_and_grad(
            neural.loss_fn, has_aux=True)(params, model, patches, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, acc

    return train_step


def train_sharded(patches, labels, mesh: Mesh | None = None,
                  epochs: int = 2, batch: int = 2048, lr: float = 3e-3,
                  seed: int = 0, log=None):
    """Data+model-parallel training; returns (params (sharded), accuracy)."""
    mesh = mesh or make_mesh()
    model, params = neural.init_params(jax.random.PRNGKey(seed))
    tx = optax.adamw(lr)
    p_sh = param_sharding(params, mesh)
    params = jax.tree.map(jax.device_put, params, p_sh)
    opt_state = tx.init(params)
    data_sh = NamedSharding(mesh, P("data"))
    step = make_train_step(mesh, tx, model)

    n = len(patches)
    rng = np.random.default_rng(seed)
    acc = jnp.zeros(())
    with mesh:
        for _epoch in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch + 1, batch):
                sel = order[i:i + batch]
                px = jax.device_put(jnp.asarray(patches[sel]), data_sh)
                ly = jax.device_put(jnp.asarray(labels[sel]), data_sh)
                params, opt_state, loss, acc = step(params, opt_state, px, ly)
            if log:
                log(f"epoch {_epoch}: loss {float(loss):.4f} "
                    f"acc {float(acc):.4f}")
    return params, float(acc)
