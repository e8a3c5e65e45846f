"""CPU-side checks of the GPU bring-up tooling: chip_smoke.py's refusals and
option handling, the nvidia-smi line parser and the compile-cache location."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

from fpga_mpeg2_encoder_tpu.utils import compile_cache
from fpga_mpeg2_encoder_tpu.utils.device import parse_card_line

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """On a CPU device, or copied away from the package, the script exits
    non-zero and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "JAX_PLATFORMS": "cpu"}
    if where == "checkout":
        env["PYTHONPATH"] = ROOT
    else:
        script = shutil.copy(script, tmp_path)
    r = subprocess.run([sys.executable, script], capture_output=True, text=True,
                       cwd=tmp_path, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    if where == "checkout":
        assert "needs an NVIDIA GPU" in r.stderr


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", 700.0)),
    ("NVIDIA H100 PCIe, 350.00 W\n", ("NVIDIA H100 PCIe", 350.0)),
    ("NVIDIA H100 80GB HBM3, [N/A]", ("NVIDIA H100 80GB HBM3", None)),
])
def test_parse_card_line(line, want):
    assert parse_card_line(line) == want
    with pytest.raises(ValueError):
        parse_card_line("no comma here")


@pytest.mark.parametrize("argv,want", [
    ([], chip_smoke.ONE_CARD_PHASES),
    (["--four-cards"], chip_smoke.FOUR_CARD_PHASES),
])
def test_chip_smoke_phase_selection(argv, want):
    """The four-card option runs its phase and nothing else; the default runs
    the one-card phases a-g."""
    got = chip_smoke.phases_for(chip_smoke.parse_args(argv))
    assert got == want
    names = [name for name, _ in got]
    if argv:
        assert len(names) == 1 and "four" in names[0]
    else:
        assert [n[0] for n in names] == list("abcdefg")


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; otherwise
    the cache is the fixed directory inside the checkout."""
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
        assert compile_cache.enable_compile_cache() == str(tmp_path / env_dir)
        assert updates == []
