"""The device layer of the benchmarks and the smoke run: compile cache,
peaks table, the no-GPU refusal, the CPU rehearsal, and the card-marked
checks that need a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(env_dir, monkeypatch, tmp_path):
    import jax

    from admm_tpu.benchmarks import device

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert device.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; no other directory is set.
        assert "jax_compilation_cache_dir" not in calls
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = device.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert calls["jax_compilation_cache_dir"] == path
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                  "NVIDIA A100-SXM4-80GB"])
def test_peaks_table(kind):
    from admm_tpu.benchmarks.device import peaks

    if kind == "NVIDIA H100 80GB HBM3":
        p = peaks(kind)
        assert p["hbm_bytes_per_s"] == 3.35e12
        assert (p["bf16_flops_per_s"], p["tf32_flops_per_s"],
                p["f32_flops_per_s"]) == (989e12, 495e12, 67e12)
        assert "data sheet" in p["source"]
    else:
        with pytest.raises(KeyError, match="no published peaks"):
            peaks(kind)


def _run(args, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_no_gpu_refuses(script):
    """Without a GPU and without the rehearsal option, nothing falls back
    to the CPU: exit non-zero, say so, print no result."""
    out = _run([script])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout


@pytest.mark.parametrize("phase", ["headline", "large", "families"])
def test_chip_smoke_cpu_rehearsal(phase):
    """Each phase of the smoke run at tiny sizes on the CPU: every check
    passes and the result line names the CPU."""
    out = _run(["chip_smoke.py", "--cpu-rehearsal", "--phase", phase],
               timeout=150)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "card: none (CPU rehearsal)"
    checks = [json.loads(x) for x in lines if x.startswith('{"check"')]
    assert checks and all(c["ok"] for c in checks)
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 4}}


def test_chip_smoke_phase_selection():
    import chip_smoke

    sel = lambda *a: chip_smoke.selected_phases(chip_smoke.parse_args(a))
    assert sel("--multi") == ["multi"]
    assert sel("--multi", "--phase", "headline") == ["multi"]
    assert sel() == ["device", "headline", "large", "families"]
    assert sel("--phase", "large") == ["large"]
    assert "multi" not in sel()


def test_matrix_cli_fails_on_oracle_row(monkeypatch):
    from admm_tpu import __main__ as cli
    from admm_tpu.benchmarks import matrix

    monkeypatch.setattr(matrix, "main",
                        lambda **kw: {"all_green": False})
    assert cli.main(["matrix", "--cpu"]) == 1
    monkeypatch.setattr(matrix, "main", lambda **kw: {"all_green": True})
    assert cli.main(["matrix", "--cpu"]) == 0


@pytest.mark.parametrize("cpu_devices", [None, 8])
def test_scaling_cli_needs_gpu_or_rehearsal(cpu_devices, monkeypatch, capsys):
    """The weak-scaling sweep stops without a GPU; ``--cpu-devices`` runs
    it on virtual CPU devices and every row says so."""
    from admm_tpu import __main__ as cli
    from admm_tpu.benchmarks import device

    monkeypatch.setattr(device, "enable_compile_cache", lambda: "")
    argv = ["scaling", "--devices", "2", "--rows-per-shard", "32",
            "--cols", "8", "--iters", "5"]
    if cpu_devices is None:
        assert cli.main(argv) == 1
        assert "no GPU" in capsys.readouterr().err
        return
    assert cli.main([*argv, "--cpu-devices", str(cpu_devices)]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r.get("devices") for r in rows[:-1]] == [1, 2]
    assert all(r["platform"] == "cpu" and r["device_kind"] == "cpu"
               for r in rows)
    assert "not a scaling measurement" in rows[-1]["caveat"]


@pytest.mark.gpu
def test_card_peaks_known(gpu):
    from admm_tpu.benchmarks.device import card_info, peaks

    assert peaks(gpu.device_kind)["hbm_bytes_per_s"] > 0
    assert card_info()


@pytest.mark.gpu
def test_card_lasso_matches_f64(gpu):
    import jax.numpy as jnp

    from admm_tpu import ADMMConfig, lasso
    from admm_tpu.benchmarks.headline import fat_lasso_instance
    from admm_tpu.testers.reference import lasso_admm_f64

    D, s, lam = fat_lasso_instance(150, 500)
    res = lasso(jnp.asarray(D), jnp.asarray(s), lam,
                ADMMConfig(maxiters=20000, abstol=1e-7, reltol=1e-6,
                           stallwindow=100))
    zref, _ = lasso_admm_f64(D, s, lam)
    x = np.asarray(res.zopt, np.float64)
    assert np.linalg.norm(x - zref) <= 1e-3 * np.linalg.norm(zref)
