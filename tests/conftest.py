"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); sharding tests run on
``xla_force_host_platform_device_count=8`` virtual CPU devices. The GPU path
is exercised by ``python chip_smoke.py`` on a card (and ``--multichip`` on
four), and by the tests marked ``gpu``, which skip without a card:
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` on a GPU machine.
The platform defaults to the CPU, in the environment (for entry points and
subprocesses) and in jax.config (in case jax was configured before).
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest  # noqa: E402


#: Drop compiled executables when the process's memory-map count crosses
#: this line. Linux caps a process at vm.max_map_count mappings (65,530
#: default); every XLA:CPU executable holds several anonymous JIT-code
#: mappings (r-xp + r--p + rw-p) until it is destroyed, so a long
#: single-process run accumulates mappings monotonically and the first
#: mmap past the cap segfaults LLVM's JIT. 30k leaves >30k headroom for
#: the heaviest single module.
_MAP_GUARD = 30_000


def _map_count() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:        # non-Linux: no cap to guard against
        return 0


@pytest.fixture(autouse=True, scope="module")
def _jax_map_guard():
    """Prevent the full-suite XLA:CPU segfault: vm.max_map_count exhaustion.

    Root-caused (r3): the single-process suite segfaulted inside XLA's
    backend_compile_and_load whenever enough modules ran first — module
    combination irrelevant, RSS only 6.6 GB. The real resource was memory
    MAPPINGS: watched live, the crashing pytest climbed to 65,332 maps
    (limit 65,530) and died at the next compile. Each compiled CPU
    executable keeps ~3 anonymous JIT mappings alive; ~250 tests' worth
    crosses the cap. jax.clear_caches() releases them (measured: one
    module's 1317 maps -> 784 after clearing), so capping the count here
    bounds the whole run. Cross-module jit cache reuse is preserved until
    the threshold actually trips (~1-2 times per full suite).
    """
    if _map_count() > _MAP_GUARD:
        jax.clear_caches()
    yield
