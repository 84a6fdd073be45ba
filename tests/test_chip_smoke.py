"""chip_smoke.py: its closing line, its refusals, and the card-only check."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("count", [1, 4])
def test_final_line(count):
    line = chip_smoke.final_line([_Dev()] * count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_refuses_without_gpu(capsys, monkeypatch):
    from versalignlib_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_kernel_compiled_on_card(gpu_device):
    """The compiled Triton kernel equals the XLA scan on the card."""
    import jax.numpy as jnp

    from versalignlib_tpu.ops import triton_score, xla
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.types import Algorithm

    rng = np.random.default_rng(3)
    reads = jnp.asarray(rng.integers(0, 6, (300, 77), dtype=np.uint8))
    refs = jnp.asarray(rng.integers(0, 6, (300, 93), dtype=np.uint8))
    for p in (AlignmentParameters(),
              AlignmentParameters(gap_open_read=-4, gap_open_ref=-3)):
        for alg in Algorithm:
            np.testing.assert_array_equal(
                triton_score.score_batch_triton(reads, refs, p, alg),
                xla.score_batch(reads, refs, p, alg))
