import os

# The suite runs on a virtual 8-device CPU mesh.  Tests marked ``chip`` need an
# NVIDIA GPU: with FPGA_MPEG2_CHIP_TESTS=1 (chip_smoke.py sets it) JAX keeps
# its default device and ``pytest -m chip`` runs them there.
import jax

if os.environ.get("FPGA_MPEG2_CHIP_TESTS") != "1":
    os.environ.setdefault(
        "XLA_FLAGS",
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (run by chip_smoke.py, or "
                   "FPGA_MPEG2_CHIP_TESTS=1 python -m pytest tests -m chip)")


@pytest.fixture(autouse=True)
def _chip_needs_gpu(request):
    """Tests marked ``chip`` skip unless JAX's first device is a GPU; decided
    here at run time, never at import."""
    if request.node.get_closest_marker("chip") is not None:
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU; JAX device is {dev.platform}")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_video(rng, width, height, n_frames, kind="pan"):
    """Synthetic YUV 4:4:4 clips: smooth gradient + texture with global pan, so
    P-frames exercise real motion vectors."""
    pad = 48
    yy, xx = np.mgrid[0:height + pad, 0:width + pad]
    tex = rng.integers(0, 64, (height + pad, width + pad)).astype(np.int32)
    base_y = ((xx * 3 + yy * 2) // 4 % 200 + tex) % 256
    base_u = ((xx - yy) // 3 % 160 + 48 + tex // 2) % 256
    base_v = ((xx + yy) // 5 % 120 + 64 + tex // 3) % 256
    frames = []
    for i in range(n_frames):
        if kind == "pan":
            dy, dx = (i * 2) % pad, (i * 3) % pad
        elif kind == "still":
            dy = dx = 0
        else:  # noise
            return [
                (rng.integers(0, 256, (height, width), dtype=np.uint8),
                 rng.integers(0, 256, (height, width), dtype=np.uint8),
                 rng.integers(0, 256, (height, width), dtype=np.uint8))
                for _ in range(n_frames)
            ]
        frames.append((
            base_y[dy:dy + height, dx:dx + width].astype(np.uint8),
            base_u[dy:dy + height, dx:dx + width].astype(np.uint8),
            base_v[dy:dy + height, dx:dx + width].astype(np.uint8),
        ))
    return frames


def structured_content(w, h, n, seed):
    """Gradient + texture frames panning 3 px right and 2 px down per frame."""
    rng = np.random.default_rng(seed)
    pad = 32
    yy, xx = np.mgrid[0:h + pad, 0:w + pad]
    tex = rng.integers(0, 48, (h + pad, w + pad)).astype(np.int32)
    y = (((xx * 3 + yy * 2) // 4) % 200 + tex).astype(np.uint8)
    u = ((xx - yy) // 3 % 160 + 48).astype(np.uint8)
    v = ((xx + yy) // 5 % 120 + 64).astype(np.uint8)
    return [(y[2 * i:2 * i + h, 3 * i:3 * i + w].copy(),
             u[2 * i:2 * i + h, 3 * i:3 * i + w].copy(),
             v[2 * i:2 * i + h, 3 * i:3 * i + w].copy()) for i in range(n)]


@pytest.fixture(scope="session")
def video_factory(rng):
    def f(width=64, height=64, n_frames=4, kind="pan"):
        return make_video(rng, width, height, n_frames, kind)
    return f
