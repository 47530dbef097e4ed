"""chip_smoke.py's phases at a tiny size on the CPU: the game truth, the
parity phase (CPU against CPU: it checks the phase's plumbing, not the
card), the end-to-end game through ckmain's objects, the stream-sharded
phase on four virtual CPU devices, and the guard that refuses to run
without a GPU. ``test_parity_on_card`` runs the parity phase on a real
card and skips without one."""

import json

import numpy as np
import pytest

import chip_smoke
from camkifu_tpu.parallel import mesh as pm


@pytest.fixture
def gpu():
    """The first CUDA device, or skip (decided here, never at import, so
    every xdist worker collects the same tests)."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU in this process (tests pin JAX to the CPU)")


def test_game_truth_has_captures_and_is_legal():
    moves, states = chip_smoke.game_states(len(chip_smoke.GAME))
    assert len(moves) >= 20
    counts = [int((s != 0).sum()) for s in states]
    drops = [i + 1 for i in range(1, len(counts))
             if counts[i] < counts[i - 1] + 1]
    assert drops == [7, 19]                      # one and two stones taken
    assert counts[6] == 6 and counts[18] == 16
    assert states[-1][3, 4] == 0 and states[-1][9, 9] == 0


def test_render_game_frames_are_distinct():
    moves, frames, corners = chip_smoke.render_game(
        3, (120, 160), fpm=3, leadin=2)
    assert len(frames) == 2 + 3 * 3 == len(corners)
    assert len({f.tobytes() for f in frames}) == len(frames)
    assert np.abs(np.diff(corners, axis=0)).max() > 0


def test_parity_phase_plumbing_on_cpu():
    import jax

    cpu = jax.devices("cpu")
    m = chip_smoke.phase_parity(cpu[0], cpu[1], frame_hw=(360, 640),
                                n_frames=8, edge_res=128)
    assert m["read_labels_identical"] and m["track_labels_identical"]
    assert m["read_labels_truth"] == 1.0
    assert m["detect_batch_truth_px"] < 3.0
    assert m["dlt_fit_px"] < 1e-2


@pytest.mark.gpu
def test_parity_on_card(gpu):
    import jax

    m = chip_smoke.phase_parity(gpu, jax.devices("cpu")[0],
                                frame_hw=(360, 640), n_frames=8,
                                edge_res=128)
    assert m["read_labels_identical"]


def test_e2e_phase_small_game_exact_kifu():
    rep = chip_smoke.phase_e2e(frame_hw=(360, 640), n_moves=8)
    assert rep["detected"] == rep["moves"] == 8


def test_multichip_phase_on_four_cpu_devices():
    import jax

    m = chip_smoke.phase_multichip(jax.devices("cpu")[:4],
                                   frame_hw=(180, 320), n_streams=8, per=4)
    assert m["sharded_on_all"]
    assert m["collectives"] == {"read": [], "meta": [], "track": []}


def test_collective_ops_finds_collectives():
    hlo = "%x = f32[8] all-reduce(%y), replica_groups={}\n%z = add(%x, %x)"
    assert pm.collective_ops(hlo) == ["all-reduce"]
    assert pm.collective_ops("%z = f32[8] add(%x, %x)") == []


def test_smoke_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert not any(line.startswith("{") and '"ok"' in line
                   for line in out.splitlines())


def test_smoke_needs_its_own_checkout(tmp_path):
    """Run alone (no package beside it), the script fails before any
    result line."""
    import shutil
    import subprocess
    import sys

    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    json_lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
    assert not any(json.loads(l).get("ok") for l in json_lines)
