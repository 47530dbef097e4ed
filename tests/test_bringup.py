"""Bring-up pieces that surround the GPU path: the numpy renderer that feeds
chip_smoke, the compile-cache location, the device guards of the entry
points and measurement scripts, and loading without flax."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from camkifu_tpu.utils import device, jaxcache, render_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (240, 320)


def _render(labels, corners=None, seed=0, noise=3.0):
    corners = render_np.default_corners(HW) if corners is None else corners
    canon = render_np.canonical_board(labels, render_np.zone_for(HW))
    return render_np.render_frame(canon, corners, HW, seed=seed,
                                  noise=noise), corners


# -- renderer ----------------------------------------------------------------

def test_render_homography_maps_source_to_corners():
    src = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float64)
    dst = render_np.default_corners(HW)
    h = render_np.homography(src, dst)
    q = h @ np.vstack([src.T, np.ones(4)])
    np.testing.assert_allclose((q[:2] / q[2]).T, dst, atol=1e-6)


def test_render_corner_stones_land_on_given_corners():
    """A stone at each corner intersection is drawn centred on the corner
    the frame was rendered for; just outside the slab is table."""
    lab = np.zeros((19, 19), np.int8)
    lab[0, 0] = lab[0, 18] = lab[18, 18] = lab[18, 0] = 1
    frame, corners = _render(lab, noise=0.0)
    for x, y in corners:
        px = frame[int(round(y)), int(round(x))].astype(float)
        np.testing.assert_allclose(px, render_np.STONE[1], atol=2.0)
    x0, y0 = corners[:, 0].min() - 15, corners[:, 1].min() - 15
    np.testing.assert_allclose(frame[int(y0), int(x0)], render_np.TABLE,
                               atol=1.0)


def test_render_disc_placement_and_color():
    """Black and white discs sit at their intersections, empty ones show
    wood or line, and an empty board holds no stone-coloured pixel."""
    lab = np.zeros((19, 19), np.int8)
    lab[4, 7], lab[12, 3] = 1, 2
    canon = render_np.canonical_board(lab, zone=20)
    at = lambda r, c: canon[int(round((r + 0.5) * 20 - 0.5)),
                            int(round((c + 0.5) * 20 - 0.5))]
    np.testing.assert_allclose(at(4, 7), render_np.STONE[1], atol=1e-3)
    np.testing.assert_allclose(at(12, 3), render_np.STONE[2], atol=1e-3)
    assert at(8, 8).max() < 200 and at(8, 8).min() > 15    # line crossing
    empty = render_np.canonical_board(np.zeros((19, 19), np.int8), zone=20)
    assert (empty.max(axis=-1) < 30).sum() == 0            # no black disc
    assert (empty.min(axis=-1) > 225).sum() == 0           # no white disc


def test_render_is_seed_deterministic():
    lab = np.zeros((19, 19), np.int8)
    lab[3, 3] = 1
    a, _ = _render(lab, seed=5)
    b, _ = _render(lab, seed=5)
    c, _ = _render(lab, seed=6)
    assert a.dtype == np.uint8 and a.shape == HW + (3,)
    np.testing.assert_array_equal(a, b)
    assert (a != c).mean() > 0.5                           # fresh noise


def test_drifting_corners_small_and_smooth():
    base = render_np.default_corners(HW)
    steps = [render_np.drifting_corners(base, t, HW) for t in range(40)]
    assert max(np.abs(s - base).max() for s in steps) < 0.02 * HW[0] + 2
    assert max(np.abs(b - a).max() for a, b in zip(steps, steps[1:])) < 1.0
    assert len({s.tobytes() for s in steps}) == 40         # every frame moves


# -- compile cache -----------------------------------------------------------

def test_jaxcache_honours_env_var(tmp_path, monkeypatch):
    import jax

    d = str(tmp_path / "envcache")
    monkeypatch.setenv(jaxcache.ENV_VAR, d)
    try:
        assert jaxcache.enable() == d
        assert jax.config.jax_compilation_cache_dir == d
        assert os.path.isdir(d)
    finally:
        monkeypatch.delenv(jaxcache.ENV_VAR)
        jaxcache.enable()


def test_jaxcache_default_without_env(monkeypatch):
    import jax

    monkeypatch.delenv(jaxcache.ENV_VAR, raising=False)
    assert jaxcache.cache_dir() == jaxcache.DEFAULT_DIR
    assert jaxcache.enable() == jaxcache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == jaxcache.DEFAULT_DIR


def test_jaxcache_default_dir_is_fixed_inside_checkout(tmp_path, monkeypatch):
    """The default cannot move with the working directory or HOME (the
    path is part of the cache key, so a moved cache never hits)."""
    assert jaxcache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    fresh = importlib.reload(jaxcache)
    assert fresh.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


# -- device guards -----------------------------------------------------------

def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_peaks_known_and_unknown_kinds():
    assert device.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        device.peaks("Some Future GPU")


def test_entry_guard_allows_requested_cpu_and_stops_otherwise(monkeypatch):
    assert device.cpu_requested()                  # tests pin the CPU
    assert device.check_entry("test")["platform"] == "cpu"
    monkeypatch.setattr(device, "cpu_requested", lambda: False)
    with pytest.raises(SystemExit, match="no GPU found"):
        device.check_entry("test")


def test_bench_refuses_cpu_and_unknown_card(monkeypatch):
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    monkeypatch.setattr(device, "describe", lambda: {
        "platform": "gpu", "kind": "Some Future GPU", "count": 1})
    with pytest.raises(ValueError, match="no published peaks"):
        bench.main()


def test_utilization_uses_the_kinds_peaks():
    import bench

    u = bench._utilization([(67e12, 0.0), (0.0, 1.675e12)], 1.0,
                           device.peaks("NVIDIA H100 80GB HBM3"))
    assert u["flops_frac"] == 1.0 and u["hbm_frac"] == 0.5
    assert u["bound"] == "flops" and u["roofline_frac"] == 1.0


# -- imports beyond the sure packages ----------------------------------------

_BLOCK_FLAX = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path, target=None):\n"
    "        if name.split('.')[0] in ('flax', 'orbax'):\n"
    "            raise ImportError('blocked ' + name)\n"
    "sys.meta_path.insert(0, Block())\n")


def _run_blocked(body: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _BLOCK_FLAX + body],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ,
                                                JAX_PLATFORMS="cpu"))


def test_registries_load_without_flax():
    r = _run_blocked(
        "from camkifu_tpu.config import cvconf\n"
        "print([c.label for c in cvconf.sfinders()],"
        " [c.__name__ for c in cvconf.bfinders()])\n"
        "assert 'flax' not in sys.modules\n")
    assert r.returncode == 0, r.stderr
    assert "'meta'" in r.stdout and "BoardFinderAuto" in r.stdout


def test_missing_checkpoint_needs_no_flax_present_one_raises(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    r = _run_blocked(
        "from camkifu_tpu.models import neural\n"
        f"assert neural.load_params({str(tmp_path / 'none')!r}) is None\n"
        "try:\n"
        f"    neural.load_params({str(ckpt)!r})\n"
        "except ImportError as e:\n"
        "    print('raised', e)\n")
    assert r.returncode == 0, r.stderr
    assert "raised blocked orbax" in r.stdout


def test_sfmeta_without_checkpoint_runs_classical(tmp_path, monkeypatch):
    from camkifu_tpu.models import neural
    from camkifu_tpu.stone.sf_meta import SfMeta

    monkeypatch.setattr(neural.load_params, "__defaults__",
                        (str(tmp_path / "no_ckpt"),))

    sf = SfMeta(None)
    assert sf.neural_params is None
    assert "neural" not in sf.metadata
